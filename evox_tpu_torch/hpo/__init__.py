"""Meta-optimization (counterpart of ``evox_tpu/hpo``).

* :class:`NestedProblem` — an entire inner workflow batch evaluated as the
  outer problem: one ``torch.func.vmap`` of the inner workflow's segment
  program, identity-keyed (``rng.fold_in(key, candidate_uid)``) inner
  streams, per-candidate inner telemetry; on the card each evaluation is a
  replayed CUDA graph;
* :class:`HPOMonitor` / :class:`HPOFitnessMonitor` — how an inner run
  reports its score, with the per-generation repeat aggregation;
* :class:`HPORunner` — resumable nested state: whole-nest checkpoints, the
  per-candidate inner histories (``candidate_history``, re-ingested on
  resume) and the ``evox_hpo_*`` metrics;
* :class:`GrowthLadder` / :class:`HPOGrowPolicy` /
  :func:`grow_evidence` / :func:`validate_ladder_window` — elastic inner
  populations: a controller's journaled ``hpo-grow`` decision regrows the
  ladder at a boundary, and resume replays the growth;
* :func:`candidate_series`, :func:`find_nested`.

:mod:`evox_tpu_torch.problems.hpo_wrapper` is the back-compat shim over
this package.
"""

from .elastic import GrowthLadder, HPOGrowPolicy, grow_evidence, validate_ladder_window
from .monitor import HPO_REPEAT_AXIS, HPOFitnessMonitor, HPOMonitor
from .nested import NestedProblem, candidate_series, find_nested
from .runner import HPORunner

__all__ = [
    "HPO_REPEAT_AXIS",
    "GrowthLadder",
    "HPOFitnessMonitor",
    "HPOGrowPolicy",
    "HPOMonitor",
    "HPORunner",
    "NestedProblem",
    "candidate_series",
    "find_nested",
    "grow_evidence",
    "validate_ladder_window",
]
