"""Structured, journaled control-plane decisions (counterpart of
``evox_tpu/control/decision.py``, a copy: the same manifest, so a decision
journaled by either package replays in the other).

Every action the :class:`~evox_tpu_torch.control.Controller` takes — a trend
verdict that fires a restart, a cadence change, a brown-out transition,
a recomputed shed threshold, a tenant degradation action, a degrade-to-
threshold-probes fallback — is one :class:`Decision`: the *kind* of
decision, the machine-readable *action*, and the full *evidence* dict it
was computed from (measured values AND the thresholds in force).

Two contracts:

* **Replayability.**  The action is a pure function of the evidence
  (:func:`~evox_tpu_torch.control.controller.decide`), so a journaled decision
  can be *recomputed* from its journaled evidence and must reproduce the
  identical action — ``Controller.replay_decisions`` does exactly that.

* **Bit-identity exclusion.**  Decisions live on the controller and in
  the journal, never in device state or checkpoint archives — exactly
  like ``num_preemptions``, they are *about* the run, not *of* it, so
  every bit-identity contract (fused==debug, packed==solo, resume==
  uninterrupted) excludes them by construction.  A controller that fires
  no decision leaves a run bit-identical to a controller-less one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

__all__ = ["Decision", "DECISION_SCHEMA_VERSION"]

#: Version stamp carried by every journaled decision record.
DECISION_SCHEMA_VERSION = 1


@dataclass
class Decision:
    """One control-plane decision, with the evidence that produced it.

    :ivar seq: controller-assigned strictly-increasing index (disjoint
        from the journal's own record ``seq``).
    :ivar kind: decision family — ``"trend"``, ``"cadence"``,
        ``"brownout"``, ``"shed-threshold"``, ``"tenant"``, or
        ``"degrade"`` (the catalog in ``docs/guide/control.md``).
    :ivar generation: the boundary generation the decision was taken at
        (a scheduling-round index for service-scope decisions).
    :ivar action: machine-readable outcome, recomputable from
        ``evidence`` via :func:`~evox_tpu_torch.control.controller.decide`.
    :ivar policy: name of the deciding policy.
    :ivar evidence: JSON-serializable inputs — measured signals *and* the
        thresholds in force, so replay needs nothing but the record.
    :ivar tenant_id: the tenant a service-scope decision concerns
        (``None`` for run/daemon-scope decisions).
    """

    seq: int
    kind: str
    generation: int
    action: str
    policy: str
    evidence: dict[str, Any] = field(default_factory=dict)
    tenant_id: str | None = None

    def to_manifest(self) -> dict[str, Any]:
        """JSON-serializable form (journal record payload)."""
        return {
            "schema": DECISION_SCHEMA_VERSION,
            "seq": int(self.seq),
            "kind": str(self.kind),
            "generation": int(self.generation),
            "action": str(self.action),
            "policy": str(self.policy),
            "evidence": dict(self.evidence),
            "tenant_id": self.tenant_id,
        }

    @classmethod
    def from_manifest(cls, data: Mapping[str, Any]) -> "Decision":
        """Inverse of :meth:`to_manifest` (unknown keys ignored, so a
        schema gain stays replayable)."""
        return cls(
            seq=int(data["seq"]),
            kind=str(data["kind"]),
            generation=int(data.get("generation", 0)),
            action=str(data["action"]),
            policy=str(data.get("policy", "")),
            evidence=dict(data.get("evidence") or {}),
            tenant_id=data.get("tenant_id"),
        )
