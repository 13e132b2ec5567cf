"""The tenant-churn soak ladder on the PyTorch port: tenants through a routed
fleet of ``evox_tpu_torch`` members, in waves (counterpart of
``tools/soak.py``: the same parameters, defaults, tenant shape, seeded
chaos and report keys).

* **tier-1 rung** (default, ``--tenants 1000``): three members, churn
  waves of 250 — big enough that an O(ever-admitted) disk, journal or
  device-memory regression shows.
* **the 100k rung** (``--tenants 100000``): the slow-marked proof run
  (``tests/test_torch_chaos.py::test_soak_100k_proof_run`` drives it).

Each wave submits a batch through the :class:`~evox_tpu_torch.service.
TenantRouter` (journal-before-ack placement per tenant), drains it to
completion, audits the full :data:`~evox_tpu_torch.resilience.INVARIANTS`
registry over a :func:`~evox_tpu_torch.resilience.build_audit_context`
fleet snapshot (exactly-once admission, no acked record lost, bounded disk,
monotone counters, SLO accounting...), then retires the wave (fetch →
forget → namespace purge) so live state — disk, placement map, compacted
journals — stays **O(wave), not O(ever-admitted)**.  With ``--chaos``,
seeded member SIGKILLs (abandon + rebuild over the same root) and
heal-on-retry disk faults ride along between waves.

The members run on ``device`` (the card unless ``--device`` names another);
each tenant's spec is built on the host and reaches the card in its
member's decode.  ``on_wave(wave, fleet, router)``, when given, is called
after each wave is retired (a caller reads the card's memory and each
member's captures there).

The run publishes the ``evox_soak_*`` gauges (the router's ``chaos``
statusz section renders the strip), returns a report whose ``platform`` is
the members' device type, and exits non-zero on any invariant violation or
incomplete wave.  It writes the report only where ``--out`` says.

Run::

    python tools/soak_torch.py --tenants 1000 --chaos
    python tools/soak_torch.py --tenants 200 --chaos --device cpu --out soak.json
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time
import warnings
from pathlib import Path
from typing import Any, Callable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from evox_tpu_torch.algorithms import PSO  # noqa: E402
from evox_tpu_torch.obs import default_slos  # noqa: E402
from evox_tpu_torch.problems.numerical import Ackley  # noqa: E402
from evox_tpu_torch.resilience import FaultyStore  # noqa: E402
from evox_tpu_torch.resilience.chaos import build_audit_context  # noqa: E402
from evox_tpu_torch.resilience.invariants import audit_invariants  # noqa: E402
from evox_tpu_torch.service import (  # noqa: E402
    AdmissionError,
    ServiceMember,
    TenantRouter,
    TenantSpec,
    TenantStatus,
)
from evox_tpu_torch.utils import ExecutableCache  # noqa: E402

DIM = 4
POP = 8
LB = torch.full((DIM,), -32.0)
UB = torch.full((DIM,), 32.0)


def _silent(fn, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


class SoakMonitor:
    """The live soak strip: attached as ``router.chaos`` so ``/statusz``
    (and ``evoxtop``) renders the run's progress — live tenants,
    injected events, violations, worst burn rate."""

    def __init__(self, name: str, tenants: int):
        self.name = name
        self.tenants = int(tenants)
        self.wave = 0
        self.waves = 0
        self.completed = 0
        self.live_tenants = 0
        self.injected_events = 0
        self.violations = 0
        self.worst_burn_rate: float | None = None

    def statusz_payload(self) -> dict[str, Any]:
        return {
            "plan": self.name,
            "round": self.wave,
            "rounds": self.waves,
            "tenants": self.tenants,
            "completed": self.completed,
            "live_tenants": self.live_tenants,
            "injected_events": self.injected_events,
            "violations": self.violations,
            "worst_burn_rate": self.worst_burn_rate,
        }


def run_soak(
    root: Any,
    *,
    device: Any = None,
    tenants: int = 1000,
    members: int = 3,
    wave: int = 250,
    n_steps: int = 4,
    lanes_per_pack: int = 16,
    segment_steps: int = 4,
    compact_records: int = 2000,
    chaos: bool = False,
    kill_every: int = 2,
    seed: int = 0,
    audit_every_wave: bool = True,
    max_wave_rounds: int = 2000,
    on_wave: Callable[[int, dict, TenantRouter], None] | None = None,
) -> dict[str, Any]:
    """Run the churn ladder; returns the JSON-ready soak report.

    Raises on a wedged wave (a tenant that never completes); invariant
    violations do NOT raise — they are collected into the report (the
    caller gates), matching the chaos conductor's collect-everything
    discipline."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = random.Random(int(seed))
    exec_cache = ExecutableCache(root / "exec")

    def build_member(index: int, store: FaultyStore | None = None):
        kwargs: dict[str, Any] = dict(
            lanes_per_pack=lanes_per_pack,
            segment_steps=segment_steps,
            seed=0,
            exec_cache=exec_cache,
            slos=default_slos(),
            compact_records=compact_records,
            device=device,
        )
        if store is not None:
            kwargs["store"] = store
        return ServiceMember(
            index, root / f"m{index}", heartbeat_dir=root / "beats", **kwargs
        )

    fleet = {i: build_member(i) for i in range(members)}
    router = TenantRouter(
        root / "router",
        [fleet[i] for i in sorted(fleet)],
        fleet_dead_after=300.0,
        fleet_start_grace=0.0,
        compact_records=compact_records,
    )
    platform = fleet[0].daemon.device.type
    monitor = SoakMonitor(f"soak-{tenants}", tenants)
    router.chaos = monitor
    _silent(router.start)

    def spec(uid: int) -> TenantSpec:
        return TenantSpec(
            f"s{uid:06d}",
            PSO(POP, LB, UB, device="cpu"),
            Ackley(),
            n_steps=n_steps,
            uid=uid,
        )

    violations: list[dict[str, Any]] = []
    forgotten: set[str] = set()
    prev_counters: dict[str, float] = {}
    completed_total = 0
    injected = 0
    peak_resident = 0
    uid = 0
    waves = (tenants + wave - 1) // wave
    monitor.waves = waves
    started = time.monotonic()
    for w in range(waves):
        monitor.wave = w
        if chaos and w and w % kill_every == 0:
            # SIGKILL as abandonment: drop the member object, rebuild
            # over the same root; sometimes the rebuilt store fails its
            # first save (heals on retry) — the journal-retry path.
            index = rng.randrange(members)
            store = (
                FaultyStore(enospc_saves=[0])
                if rng.random() < 0.5
                else None
            )
            fleet.pop(index, None)
            member = build_member(index, store)
            fleet[index] = member
            router._register(member)
            router._dead.discard(index)
            router.links[index] = member
            _silent(member.start)
            injected += 1 + (1 if store is not None else 0)
            monitor.injected_events = injected
        count = min(wave, tenants - w * wave)
        wave_acks: list[dict[str, Any]] = []
        wave_ids: list[str] = []
        for _ in range(count):
            s = spec(uid)
            uid += 1
            for _attempt in range(8):
                try:
                    record = _silent(router.submit, s)
                    break
                except AdmissionError:
                    _silent(router.step)
            else:
                raise RuntimeError(
                    f"wave {w}: tenant {s.tenant_id} refused 8 times"
                )
            wave_acks.append(
                {
                    "tenant_id": s.tenant_id,
                    "uid": int(record.uid),
                    "kind": "submit",
                    "round": w,
                }
            )
            wave_ids.append(s.tenant_id)
        rounds = 0
        while rounds < max_wave_rounds:
            _silent(router.step)
            rounds += 1
            done = True
            for tid in wave_ids:
                placement = router._placements.get(tid)
                if placement is None:
                    done = False
                    break
                record = fleet[placement["member"]].daemon.tenant(tid)
                if record.status is not TenantStatus.COMPLETED:
                    done = False
                    break
            if done:
                break
        else:
            raise RuntimeError(
                f"wave {w}: not complete after {max_wave_rounds} rounds"
            )
        if audit_every_wave or w == waves - 1:
            # Audit BEFORE retiring the wave: placements, namespaces and
            # this wave's acks are all still live evidence.
            counters = {
                "soak.completed": float(completed_total),
                "soak.waves": float(w + 1),
            }
            ctx = build_audit_context(
                router,
                acks=wave_acks,
                round=w,
                forgotten=forgotten,
                counters=counters,
                previous_counters=prev_counters,
            )
            prev_counters = dict(ctx.counters)
            found = audit_invariants(ctx)
            violations.extend(v.to_json() for v in found)
            peak_resident = max(
                peak_resident,
                sum(len(names) for names in ctx.resident.values()),
            )
            monitor.violations = len(violations)
        # Retire the wave: fetch is implicit in COMPLETED; forget purges
        # the namespace — live state stays O(wave).
        for tid in wave_ids:
            placement = router._placements.pop(tid)
            fleet[placement["member"]].daemon.forget(tid)
            forgotten.add(tid)
        completed_total += len(wave_ids)
        monitor.completed = completed_total
        monitor.live_tenants = len(router._placements)
        worst = None
        for member in fleet.values():
            if member.daemon.slo is None:
                continue
            for row in member.daemon.slo.describe():
                burn = row.get("burn_rate")
                if burn is not None and (worst is None or burn > worst):
                    worst = float(burn)
        monitor.worst_burn_rate = worst
        router._gauge(
            "evox_soak_completed", float(completed_total),
            "Tenants churned through the soak ladder, lifetime.",
        )
        router._gauge(
            "evox_soak_live_tenants", float(len(router._placements)),
            "Tenants currently placed (bounded by the wave size).",
        )
        router._gauge(
            "evox_soak_violations", float(len(violations)),
            "Invariant violations detected by the soak audit.",
        )
        router._gauge(
            "evox_soak_injected_events", float(injected),
            "Chaos events injected between soak waves.",
        )
        if worst is not None:
            router._gauge(
                "evox_soak_worst_burn_rate", worst,
                "Worst SLO burn rate across the fleet.",
            )
        if on_wave is not None:
            on_wave(w, fleet, router)
    elapsed = time.monotonic() - started
    slo_report = {
        f"member:{i}": member.daemon.slo.describe()
        for i, member in sorted(fleet.items())
        if member.daemon.slo is not None
    }
    worst = None
    for rows in slo_report.values():
        for row in rows:
            burn = row.get("burn_rate")
            if burn is not None and (worst is None or burn > worst):
                worst = float(burn)
    records_since = {
        f"member:{i}": int(
            getattr(member.daemon.journal, "records_since_snapshot", 0) or 0
        )
        for i, member in sorted(fleet.items())
    }
    records_since["router"] = int(
        getattr(router.journal, "records_since_snapshot", 0) or 0
    )
    resident_final = sum(
        1
        for i, member in fleet.items()
        for p in (Path(member.root) / "tenants").glob("*")
        if p.is_dir()
    )
    tps = completed_total / elapsed if elapsed > 0 else 0.0
    report = {
        "metric": (
            f"Soak churn throughput, tenants/sec ({members} members, "
            f"wave {wave}, pop={POP}, dim={DIM}, {n_steps} steps)"
        ),
        "value": round(tps, 3),
        "platform": platform,
        "tenants": tenants,
        "completed": completed_total,
        "waves": waves,
        "chaos": bool(chaos),
        "injected_events": injected,
        "violations": violations,
        "elapsed_seconds": round(elapsed, 3),
        "peak_resident_namespaces": peak_resident,
        "final_resident_namespaces": resident_final,
        "records_since_snapshot": records_since,
        "compact_records": compact_records,
        "slo_burn_report": {
            "worst_burn_rate": worst,
            "scopes": slo_report,
        },
    }
    router.close()
    for member in fleet.values():
        member.close()
    return report


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tenants", type=int, default=1000)
    parser.add_argument("--members", type=int, default=3)
    parser.add_argument("--wave", type=int, default=250)
    parser.add_argument("--n-steps", type=int, default=4)
    parser.add_argument("--chaos", action="store_true",
                        help="seeded member kills + disk faults between waves")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="where the members run (default: the CUDA card)")
    parser.add_argument("--workdir", default=None,
                        help="run directory (default: a fresh tempdir, removed)")
    parser.add_argument("--out", default=None,
                        help="write the JSON report here (default: print only)")
    args = parser.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="evox_soak_torch_")
    try:
        report = run_soak(
            workdir,
            device=args.device,
            tenants=args.tenants,
            members=args.members,
            wave=args.wave,
            n_steps=args.n_steps,
            chaos=args.chaos,
            seed=args.seed,
        )
    finally:
        if args.workdir is None:
            shutil.rmtree(workdir, ignore_errors=True)
    print(
        f"soak: {report['completed']}/{report['tenants']} tenants through "
        f"{report['waves']} waves in {report['elapsed_seconds']}s "
        f"({report['value']} tenants/s on {report['platform']}), "
        f"{report['injected_events']} chaos events, "
        f"{len(report['violations'])} violations, "
        f"peak resident {report['peak_resident_namespaces']} namespaces"
    )
    print(json.dumps(report, sort_keys=True))
    if args.out is not None:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    if report["violations"]:
        print("INVARIANT VIOLATIONS:")
        for v in report["violations"]:
            print(f"  [{v['invariant']}] {v['summary']}")
        return 1
    if report["completed"] != report["tenants"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
