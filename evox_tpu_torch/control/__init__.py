"""Closed-loop adaptive control plane: observe → decide → act (counterpart
of ``evox_tpu/control``, a copy: pure host code).

The observability plane records per-generation flight signals and
per-segment timings; this package *consumes* those signals: a
:class:`Controller` renders structured, journaled :class:`Decision`\\ s —
trend verdicts that fire restarts before a run wedges, self-tuned segment
cadence from measured capture/execute ratios, elastic inner-population
growth for meta-optimization, and graduated degradation (tenant
restart/quarantine/evict scoring, brown-out hysteresis, SLO-aware shed
thresholds, fleet autoscaling, journal compaction) — and the
:class:`~evox_tpu_torch.resilience.ResilientRunner` and
:class:`~evox_tpu_torch.hpo.HPORunner` act on them.

Contracts:

* every decision's action is a **pure function of its journaled
  evidence** (the ``decide_*`` functions), so a replayed journal — of
  either package — reproduces the identical decision sequence;
* decisions are excluded from bit-identity the way ``num_preemptions``
  is — a controller that fires no decision leaves the run bit-identical
  to a controller-less one;
* the controller **never crashes a run**: missing/NaN signals, a
  detached flight recorder, torn decision records, and failed journal
  appends all degrade to the existing threshold probes with one
  structured warning.

Strictly host-side at segment boundaries: nothing here reads the card.
"""

from .controller import (
    Controller,
    decide,
    decide_autoscale,
    decide_brownout,
    decide_cadence,
    decide_compact,
    decide_hpo_grow,
    decide_shed,
    decide_tenant,
    decide_trend,
)
from .decision import DECISION_SCHEMA_VERSION, Decision

__all__ = [
    "DECISION_SCHEMA_VERSION",
    "Controller",
    "Decision",
    "decide",
    "decide_autoscale",
    "decide_brownout",
    "decide_cadence",
    "decide_compact",
    "decide_hpo_grow",
    "decide_shed",
    "decide_tenant",
    "decide_trend",
]
