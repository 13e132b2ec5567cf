"""Meta-optimization (counterpart of ``evox_tpu/hpo``): the nested core.

* :class:`NestedProblem` — an entire inner workflow batch evaluated as the
  outer problem: one ``torch.func.vmap`` of the inner workflow's segment
  program, identity-keyed (``rng.fold_in(key, candidate_uid)``) inner
  streams, per-candidate inner telemetry; on the card each evaluation is a
  replayed CUDA graph;
* :class:`HPOMonitor` / :class:`HPOFitnessMonitor` — how an inner run
  reports its score, with the per-generation repeat aggregation;
* :func:`candidate_series`, :func:`find_nested`.

:mod:`evox_tpu_torch.problems.hpo_wrapper` is the back-compat shim over
this package.

Not ported yet: ``HPORunner`` (resumable nested state), ``GrowthLadder``,
``HPOGrowPolicy``, ``grow_evidence`` and ``validate_ladder_window``
(elastic inner populations).  They need ``resilience.restart``,
``resilience.runner``, ``utils.checkpoint`` and ``obs.flight``, which come
with the host planes (ROADMAP Queue 1 item 13); importing one of those
names raises :class:`ImportError`.
"""

from .monitor import HPO_REPEAT_AXIS, HPOFitnessMonitor, HPOMonitor
from .nested import NestedProblem, candidate_series, find_nested

__all__ = [
    "HPO_REPEAT_AXIS",
    "HPOFitnessMonitor",
    "HPOMonitor",
    "NestedProblem",
    "candidate_series",
    "find_nested",
]

_NOT_PORTED = ("HPORunner", "GrowthLadder", "HPOGrowPolicy", "grow_evidence", "validate_ladder_window")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise ImportError(
            f"evox_tpu_torch.hpo.{name} is not ported yet: it needs resilience.restart, resilience.runner, "
            f"utils.checkpoint and obs.flight (ROADMAP Queue 1 item 13, the host planes)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
