"""minibrax: a vendored, minimal, brax-API-compatible physics engine
(counterpart of ``evox_tpu/problems/neuroevolution/minibrax``), in tensor
operations.

It honours the API slice that
:class:`~evox_tpu_torch.problems.neuroevolution.BraxProblem` consumes:

* ``envs.get_environment(env_name=..., device=...)`` → ``Env`` objects
  with pure ``reset``/``step``, ``observation_size``/``action_size``,
  ``sys``;
* ``envs.State`` carrying ``pipeline_state``/``obs``/``reward``/``done``;
* ``io.html.render(sys, trajectory)`` / ``io.image.render_array(...)``.

:func:`activate` aliases this package as ``brax`` in ``sys.modules``, only
when no ``brax`` is importable, for the rest of the process.  A test that
must leave ``sys.modules`` as it found it installs it under ``brax``,
``brax.envs``, ``brax.io``, ``brax.io.html`` and ``brax.io.image`` with
``monkeypatch.setitem``: the JAX package's tests alias the JAX ``minibrax``
as ``brax`` in the same process, and ``activate`` would then hand back
that one.
"""

from __future__ import annotations

from . import envs, io  # noqa: F401  (the adapter reaches these by attribute)
from .physics import PipelineState, System, pipeline_init, pipeline_step  # noqa: F401

__all__ = ["envs", "io", "activate", "System", "PipelineState", "pipeline_init", "pipeline_step"]


def activate():
    """Install minibrax as ``brax`` in ``sys.modules`` if brax is absent.

    Returns whichever module will answer ``import brax`` afterwards."""
    import sys as _sys

    from ..utils import alias_vendored

    return alias_vendored(
        "brax",
        _sys.modules[__name__],
        {"envs": envs, "io": io, "io.html": io.html, "io.image": io.image},
    )
