"""Global serving-stack invariants: the registry the chaos conductor audits
(counterpart of ``evox_tpu/resilience/invariants.py``, a copy: the port
imports nothing of the JAX package, and every verdict, summary string and
evidence dict is the JAX package's).

Every durability and accounting promise the serving planes make — the
gateway's exactly-once admission, the journal-before-ack contract, the
router's single-writer placement discipline, bounded disk through tenant
churn, monotone fleet counters, SLO arithmetic — is stated here ONCE as a
pure checker over a plain :class:`AuditContext` snapshot, so the same
definition is enforced three ways:

* **continuously**, by :class:`~evox_tpu_torch.resilience.chaos.ChaosConductor`
  against the live fleet between scheduling rounds;
* **at scale**, by ``tools/soak_torch.py`` through the 100k-tenant churn ladder;
* **adversarially**, by the mutation tests (``tests/test_torch_chaos.py``): for
  every registered invariant there is a seeded tampering — a torn ack, a
  double admit, an orphaned namespace, a deleted acked record — that MUST
  produce its violation, so a checker that silently rots fails the suite.

Checkers never raise on violation: they return structured
:class:`InvariantViolation` evidence (the conductor dumps each through the
:class:`~evox_tpu_torch.obs.FlightRecorder` postmortem path), because a chaos
run's job is to *collect* every broken promise, not stop at the first.

Stdlib-only and side-effect free: a checker reads the snapshot it is
given.  Building the snapshot from a live fleet is the conductor's job
(``chaos.build_audit_context``).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Mapping

__all__ = [
    "AuditContext",
    "InvariantViolation",
    "INVARIANTS",
    "audit_invariants",
]

#: Tolerance for SLO burn-rate arithmetic recomputation (pure float math
#: re-derived from the same integers; anything above rounding noise is an
#: accounting inconsistency, not imprecision).
_SLO_TOLERANCE = 1e-6


@dataclass
class InvariantViolation:
    """One broken promise, with the evidence to reproduce the verdict.

    :param invariant: registry key of the checker that fired.
    :param summary: one-line human statement of what broke.
    :param evidence: the snapshot slice the verdict was computed from —
        JSON-ready, dumped verbatim into the postmortem bundle manifest.
    :param round: the audit round the violation was detected at.
    """

    invariant: str
    summary: str
    evidence: dict[str, Any] = field(default_factory=dict)
    round: int = 0

    def to_json(self) -> dict[str, Any]:
        return asdict(self)


@dataclass
class AuditContext:
    """A plain snapshot of the whole-stack state one audit runs against.

    Every field defaults to empty so mutation tests can construct exactly
    the slice a checker reads — and tamper with it — without standing up
    a fleet.  The conductor fills all of them from the live system.
    """

    #: Audit round number (stamped into violations).
    round: int = 0
    #: Every ack the client plane received, in order:
    #: ``{"tenant_id", "uid", "kind" ("submit"/"steer"), "round"}``.
    acks: list[dict[str, Any]] = field(default_factory=list)
    #: The router journal, replayed to plain dicts:
    #: ``{"kind", "data": {...}}`` per record.
    router_records: list[dict[str, Any]] = field(default_factory=list)
    #: Each member's journal, replayed the same way, keyed by member index.
    member_records: dict[int, list[dict[str, Any]]] = field(
        default_factory=dict
    )
    #: The router's authoritative placement map:
    #: ``tenant_id -> {"member", "uid", ...}``.
    placements: dict[str, dict[str, Any]] = field(default_factory=dict)
    #: Tenants that have completed (results fetchable).
    completed: set[str] = field(default_factory=set)
    #: Tenants explicitly retired/forgotten — their disk must be GONE.
    forgotten: set[str] = field(default_factory=set)
    #: Member indices currently alive (not SIGKILLed, not retired).
    live_members: set[int] = field(default_factory=set)
    #: Tenant namespaces present on disk, keyed by member index.
    resident: dict[int, set[str]] = field(default_factory=dict)
    #: Monotone fleet counters, this audit and the previous one.
    counters: dict[str, float] = field(default_factory=dict)
    previous_counters: dict[str, float] = field(default_factory=dict)
    #: ``SLOTracker.describe()`` rows per scope (member index or "router").
    slo_reports: dict[str, list[dict[str, Any]]] = field(
        default_factory=dict
    )
    #: Journal growth per scope, and the compaction threshold that bounds
    #: it (``None`` = compaction unarmed for that scope: growth unchecked).
    records_since_snapshot: dict[str, int] = field(default_factory=dict)
    compact_records: dict[str, int | None] = field(default_factory=dict)
    #: Scopes whose journal has been compacted (a ``snapshot-anchor``
    #: record seen): per-record counting checks relax there — folded
    #: records are *gone by design*, not lost.
    compacted_scopes: set[str] = field(default_factory=set)


def _acked_submits(ctx: AuditContext) -> dict[str, list[dict[str, Any]]]:
    out: dict[str, list[dict[str, Any]]] = {}
    for ack in ctx.acks:
        if ack.get("kind") == "submit":
            out.setdefault(str(ack["tenant_id"]), []).append(ack)
    return out


def _journaled_tenants(ctx: AuditContext, *kinds: str) -> set[str]:
    return {
        str(rec.get("data", {}).get("tenant_id"))
        for rec in ctx.router_records
        if rec.get("kind") in kinds and rec.get("data", {}).get("tenant_id")
    }


def check_exactly_once_admission(
    ctx: AuditContext,
) -> list[InvariantViolation]:
    """Exactly-once admission under retries: every acked tenant has
    exactly one ``placement`` record in the router journal (migrations
    append ``migration`` records — identity moves, it is never re-minted)
    and at most one ``submit`` record in any one member journal."""
    violations: list[InvariantViolation] = []
    placement_counts: dict[str, int] = {}
    for rec in ctx.router_records:
        if rec.get("kind") == "placement":
            tid = str(rec.get("data", {}).get("tenant_id"))
            placement_counts[tid] = placement_counts.get(tid, 0) + 1
    for tid in sorted(_acked_submits(ctx)):
        n = placement_counts.get(tid, 0)
        # After router-journal compaction the original placement record is
        # folded into the snapshot (count 0 is legitimate); >1 is a
        # double-mint regardless.
        if n > 1 or (n == 0 and "router" not in ctx.compacted_scopes):
            violations.append(
                InvariantViolation(
                    "exactly-once-admission",
                    f"tenant {tid!r} was acked but has {n} placement "
                    f"record(s) in the router journal (exactly 1 required)",
                    {"tenant_id": tid, "placement_records": n},
                    ctx.round,
                )
            )
    for member, records in sorted(ctx.member_records.items()):
        submit_counts: dict[str, int] = {}
        for rec in records:
            if rec.get("kind") == "submit":
                tid = str(rec.get("data", {}).get("tenant_id"))
                submit_counts[tid] = submit_counts.get(tid, 0) + 1
        for tid, n in sorted(submit_counts.items()):
            if n > 1:
                violations.append(
                    InvariantViolation(
                        "exactly-once-admission",
                        f"member {member} journal holds {n} submit "
                        f"records for tenant {tid!r} (a retry was "
                        f"double-admitted)",
                        {"member": member, "tenant_id": tid, "submits": n},
                        ctx.round,
                    )
                )
    return violations


def check_reply_after_journal(ctx: AuditContext) -> list[InvariantViolation]:
    """Reply only after journal append: every ack the client plane holds
    from THIS round is cross-checked against a durable journal record —
    an ack without its record is a torn ack (the reply raced the fsync,
    the exact window journal-before-ack exists to close)."""
    violations: list[InvariantViolation] = []
    placed = _journaled_tenants(ctx, "placement", "migration")
    steered = _journaled_tenants(ctx, "steer")
    compacted = "router" in ctx.compacted_scopes
    if compacted:
        # Compaction folds records into the snapshot; the placement map
        # restored from it is the surviving durable evidence.
        placed |= set(ctx.placements)
    for ack in ctx.acks:
        if int(ack.get("round", -1)) != int(ctx.round):
            continue
        tid = str(ack["tenant_id"])
        kind = str(ack.get("kind", "submit"))
        if kind == "steer" and compacted:
            continue
        journaled = steered if kind == "steer" else placed
        if tid not in journaled:
            violations.append(
                InvariantViolation(
                    "reply-after-journal",
                    f"{kind} ack for tenant {tid!r} has no durable "
                    f"journal record backing it (torn ack)",
                    {"tenant_id": tid, "kind": kind},
                    ctx.round,
                )
            )
    return violations


def check_single_writer_per_namespace(
    ctx: AuditContext,
) -> list[InvariantViolation]:
    """Single writer per namespace: a tenant's checkpoint namespace is
    resident only on its placed member among LIVE members.  (A dead
    member's stale copy is legitimate migration residue; a live
    non-owner holding the namespace means two daemons could publish into
    one tenant's checkpoint chain.)"""
    violations: list[InvariantViolation] = []
    for tid, placement in sorted(ctx.placements.items()):
        owner = int(placement.get("member", -1))
        holders = sorted(
            member
            for member, tenants in ctx.resident.items()
            if tid in tenants and member in ctx.live_members
        )
        rogue = [m for m in holders if m != owner]
        if rogue:
            violations.append(
                InvariantViolation(
                    "single-writer-per-namespace",
                    f"tenant {tid!r} is placed on member {owner} but its "
                    f"namespace is resident on live member(s) {rogue} too",
                    {"tenant_id": tid, "owner": owner, "holders": holders},
                    ctx.round,
                )
            )
    return violations


def check_no_acked_record_lost(
    ctx: AuditContext,
) -> list[InvariantViolation]:
    """No acked record lost across restarts: every tenant whose submit
    was acked is still accounted for — placed, completed, or explicitly
    forgotten.  A tenant that vanished (its journal record deleted or
    dropped by a replay hole) is the one loss the whole journal
    discipline exists to prevent."""
    violations: list[InvariantViolation] = []
    for tid in sorted(_acked_submits(ctx)):
        if tid in ctx.forgotten:
            continue
        if tid not in ctx.placements and tid not in ctx.completed:
            violations.append(
                InvariantViolation(
                    "no-acked-record-lost",
                    f"tenant {tid!r} was acked but is neither placed, "
                    f"completed, nor forgotten (an acked record was lost)",
                    {"tenant_id": tid},
                    ctx.round,
                )
            )
    return violations


def check_bounded_disk(ctx: AuditContext) -> list[InvariantViolation]:
    """O(live-tenants) disk through churn: no orphaned tenant namespace
    (a directory for a tenant that is neither placed nor completed), no
    namespace surviving its tenant's retirement, and no journal growing
    unboundedly past its armed compaction threshold."""
    violations: list[InvariantViolation] = []
    retained = set(ctx.placements) | set(ctx.completed)
    for member, tenants in sorted(ctx.resident.items()):
        if member not in ctx.live_members:
            continue
        for tid in sorted(tenants):
            if tid in ctx.forgotten:
                violations.append(
                    InvariantViolation(
                        "bounded-disk",
                        f"tenant {tid!r} was forgotten but its namespace "
                        f"survives on member {member} (retention purge "
                        f"failed; disk grows O(ever-admitted))",
                        {"tenant_id": tid, "member": member},
                        ctx.round,
                    )
                )
            elif tid not in retained:
                violations.append(
                    InvariantViolation(
                        "bounded-disk",
                        f"orphaned namespace: member {member} holds a "
                        f"directory for tenant {tid!r}, which is neither "
                        f"placed nor completed",
                        {"tenant_id": tid, "member": member},
                        ctx.round,
                    )
                )
    for scope, since in sorted(ctx.records_since_snapshot.items()):
        threshold = ctx.compact_records.get(scope)
        if threshold is not None and since > 4 * int(threshold):
            violations.append(
                InvariantViolation(
                    "bounded-disk",
                    f"{scope} journal holds {since} records past its "
                    f"snapshot with compaction armed at {threshold} "
                    f"(recovery time is no longer bounded by cadence)",
                    {
                        "scope": scope,
                        "records_since_snapshot": since,
                        "compact_records": threshold,
                    },
                    ctx.round,
                )
            )
    return violations


def check_monotone_counters(ctx: AuditContext) -> list[InvariantViolation]:
    """Monotone fleet counters: a lifetime counter (submissions,
    completions, placements, rounds, injected events) that DECREASES
    between audits means a restart dropped journaled history or an
    accounting path double-books."""
    violations: list[InvariantViolation] = []
    for name, prev in sorted(ctx.previous_counters.items()):
        current = ctx.counters.get(name)
        if current is not None and float(current) < float(prev):
            violations.append(
                InvariantViolation(
                    "monotone-counters",
                    f"counter {name!r} decreased between audits "
                    f"({prev} -> {current})",
                    {"counter": name, "previous": prev, "current": current},
                    ctx.round,
                )
            )
    return violations


def check_slo_accounting(ctx: AuditContext) -> list[InvariantViolation]:
    """SLO-accounting consistency: every ``describe()`` row's published
    burn rate and budget remainder must re-derive from its own good/bad
    integers — ``burn = (bad/total)/error_budget``,
    ``budget_remaining = 1 - burn`` — and event counts must be
    non-negative.  A row that disagrees with its own arithmetic is
    corrupted accounting, however healthy it claims to be."""
    violations: list[InvariantViolation] = []
    for scope, rows in sorted(ctx.slo_reports.items()):
        for row in rows:
            try:
                good = float(row["good"])
                bad = float(row["bad"])
                target = float(row["target"])
                # burn_rate / budget_remaining are None while the rolling
                # window is empty — no evidence is not an inconsistency.
                burn = row["burn_rate"]
                remaining = row["budget_remaining"]
                if burn is not None:
                    burn = float(burn)
                if remaining is not None:
                    remaining = float(remaining)
            except (KeyError, TypeError, ValueError) as e:
                violations.append(
                    InvariantViolation(
                        "slo-accounting",
                        f"{scope} SLO row {row.get('slo')!r} is "
                        f"malformed ({type(e).__name__}: {e})",
                        {"scope": scope, "row": dict(row)},
                        ctx.round,
                    )
                )
                continue
            problems: list[str] = []
            if good < 0 or bad < 0:
                problems.append(f"negative event counts (good={good}, bad={bad})")
            total = good + bad
            error_budget = 1.0 - target
            if total > 0 and error_budget > 0:
                expected = (bad / total) / error_budget
                if burn is None or remaining is None:
                    problems.append(
                        f"window holds {int(total)} events but burn_rate/"
                        f"budget_remaining are unpublished (None)"
                    )
                else:
                    if abs(burn - expected) > _SLO_TOLERANCE:
                        problems.append(
                            f"burn_rate {burn} != (bad/total)/error_budget "
                            f"= {expected}"
                        )
                    if abs(remaining - (1.0 - expected)) > _SLO_TOLERANCE:
                        problems.append(
                            f"budget_remaining {remaining} != 1 - burn "
                            f"= {1.0 - expected}"
                        )
            for problem in problems:
                violations.append(
                    InvariantViolation(
                        "slo-accounting",
                        f"{scope} SLO row {row.get('slo')!r}: {problem}",
                        {"scope": scope, "row": dict(row)},
                        ctx.round,
                    )
                )
    return violations


#: The registry the conductor audits continuously — key is the violation's
#: ``invariant`` name; every entry has a mutation test proving it live.
INVARIANTS: dict[
    str, Callable[[AuditContext], list[InvariantViolation]]
] = {
    "exactly-once-admission": check_exactly_once_admission,
    "reply-after-journal": check_reply_after_journal,
    "single-writer-per-namespace": check_single_writer_per_namespace,
    "no-acked-record-lost": check_no_acked_record_lost,
    "bounded-disk": check_bounded_disk,
    "monotone-counters": check_monotone_counters,
    "slo-accounting": check_slo_accounting,
}


def audit_invariants(
    ctx: AuditContext,
    registry: Mapping[
        str, Callable[[AuditContext], list[InvariantViolation]]
    ] | None = None,
) -> list[InvariantViolation]:
    """Run every registered checker over one snapshot; returns the
    violations, in registry order (empty = every promise held)."""
    violations: list[InvariantViolation] = []
    for name, checker in (registry or INVARIANTS).items():
        found = checker(ctx)
        for violation in found:
            if violation.invariant != name:
                # A checker mis-labelling its own violations would break
                # the mutation tests' liveness proof — surface it.
                violation.evidence.setdefault("registered_as", name)
        violations.extend(found)
    return violations
