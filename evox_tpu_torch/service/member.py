"""One host of the routed fleet: a daemon plus its capacity advertisement
(counterpart of ``evox_tpu/service/member.py``: the same payload keys,
routes, status codes and error names).

A :class:`ServiceMember` wraps one per-host
:class:`~evox_tpu_torch.service.ServiceDaemon` (its own root, journal, and
program cache) and gives the scheduling plane the two things a
:class:`~evox_tpu_torch.service.TenantRouter` needs from a host:

* **Capacity advertisement over the heartbeat plane.**  The member's
  :meth:`capacity` snapshot — free lanes per bucket, queue depth per
  admission class, the measured segment cadence, and program-cache
  warmth — rides every :class:`~evox_tpu_torch.parallel.HostHeartbeat`
  beat through the existing ``extra=`` payload hook, so the same
  ``host_<i>.json`` files that feed
  :class:`~evox_tpu_torch.parallel.FleetHealth` liveness verdicts also
  carry the placement signal.
* **A transport-shaped forward link.**  :meth:`request` speaks the exact
  ``(method, path, headers, body) -> (status, headers, body)`` interface
  :class:`~evox_tpu_torch.resilience.FaultyTransport` wraps, so member-link
  chaos — dropped, torn, delayed, duplicated forwards — injects on the
  router→member seam with the same fixture the gateway's client seam
  uses.  The link carries only the mutating forwards (submit / steer /
  park); reads stay on the daemon's own read-only providers.

Replies are structured JSON and every refusal keeps the daemon's
machine-readable reason and retry hints, so the router can degrade a
failed forward to the gateway's 503 + ``Retry-After`` instead of wedging.

**The device.**  The daemon runs on the card unless ``device=`` names
another (``ServiceDaemon``'s default).  A forwarded spec blob is
device-free (the router encodes it from the host); :meth:`request` decodes
it onto ``daemon.device``.  :meth:`capacity` and :meth:`load` read host
state only (record statuses, lane and queue counts, the measured cadence,
cache counters, the SLO standings): beat and endpoint threads call them
while the serving thread may hold a CUDA graph capture open, and a tensor
read from another thread then would invalidate the capture.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Mapping, Union

from .daemon import ServiceDaemon, _bucket_label, _decode_spec
from .service import AdmissionError
from .tenant import TenantStatus

__all__ = ["ServiceMember", "MEMBER_API_PREFIX"]

#: Path prefix of the member forward link (the router-facing write API).
MEMBER_API_PREFIX = "/member/v1"

_JSON_HEADERS = {"Content-Type": "application/json"}

#: AdmissionError reason -> HTTP status on the member link.  Mirrors the
#: gateway's client-facing mapping so a refusal keeps its meaning across
#: the extra hop (429 = retryable overload, 503 = retryable fault,
#: 409 = non-retryable collision).
_REASON_STATUS = {
    "shed": 429,
    "queue-full": 503,
    "journal-failed": 503,
    "id-collision": 409,
    "uid-collision": 409,
    "uid-mismatch": 409,
}


class ServiceMember:
    """One fleet host: a :class:`~evox_tpu_torch.service.ServiceDaemon`
    plus capacity advertisement and the router-facing forward link.

    :param index: this member's stable fleet index (its heartbeat
        ``process_index`` and the router's placement-record key).
    :param root: the member daemon's own root — per-host journal, tenant
        namespaces, and program cache live under it.  Member roots must
        be distinct (the router enforces it).
    :param heartbeat_dir: the fleet's shared heartbeat directory.
        ``None`` disables beats (the router then registers a beat into its
        own plane).
    :param heartbeat_interval: liveness-republish period of the beat
        thread (only relevant after ``heartbeat.start()``; the router
        beats synchronously each round).
    :param daemon: a pre-built daemon to wrap (tests / custom wiring);
        built from ``daemon_kwargs`` over ``root`` otherwise.
    :param daemon_kwargs: forwarded to :class:`ServiceDaemon` — the router
        requires ``seed`` / ``segment_steps`` / ``device`` to agree across
        members so a migrated tenant's trajectory stays bit-identical.
    """

    def __init__(
        self,
        index: int,
        root: Union[str, Path],
        *,
        heartbeat_dir: Union[str, Path, None] = None,
        heartbeat_interval: float = 0.5,
        daemon: ServiceDaemon | None = None,
        **daemon_kwargs: Any,
    ):
        if int(index) < 0:
            raise ValueError(f"member index must be >= 0, got {index}")
        self.index = int(index)
        self.root = Path(root)
        self.daemon = (
            daemon
            if daemon is not None
            else ServiceDaemon(self.root, **daemon_kwargs)
        )
        #: Router intent flags: a draining member takes no new placements
        #: (existing tenants run to completion); a retired one is
        #: read-only (results of completed tenants stay fetchable) and is
        #: never stepped or placed on again.
        self.draining = False
        self.retired = False
        self.heartbeat: Any | None = None
        if heartbeat_dir is not None:
            from ..parallel.multihost import HostHeartbeat

            self.heartbeat = HostHeartbeat(
                heartbeat_dir,
                process_index=self.index,
                interval=heartbeat_interval,
                extra=self.capacity,
                metrics=self.daemon._registry,
            )

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> int:
        """Start the wrapped daemon (journal replay); returns the number
        of tenants it restored.  Idempotent."""
        restored = self.daemon.start()
        self.beat()
        return restored

    def step(self) -> bool:
        """One scheduling round on this member's daemon, then a fresh
        progress beat (generation = segments run, so a frozen daemon with
        a live beat reads as *wedged*, not dead)."""
        busy = self.daemon.step()
        self.beat()
        return busy

    def beat(self, **fields: Any) -> None:
        """Publish one progress beat carrying the capacity payload
        (``extra=``).  No-op without a heartbeat directory."""
        if self.heartbeat is not None:
            self.heartbeat.beat(
                generation=self.daemon.service.stats.segments_run,
                segment_seconds=self.daemon._last_segment_seconds,
                **fields,
            )

    def close(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()
        self.daemon.close()

    # -- capacity advertisement ----------------------------------------------
    def capacity(self) -> dict[str, Any]:
        """The placement signal, JSON-ready (it rides every heartbeat):
        tenant counts, free lanes per live bucket, per-class queue depths,
        the measured segment cadence, and program-cache warmth.  Host
        state only, snapshot-safe (beat and endpoint threads call it
        mid-boundary, possibly inside another thread's capture)."""
        svc = self.daemon.service
        running = queued = 0
        bucket_lanes: dict[str, int] = {}
        for rec in list(svc._tenants.values()):
            if rec.status is TenantStatus.RUNNING:
                running += 1
                if rec.bucket is not None:
                    label = _bucket_label(rec.bucket)
                    bucket_lanes[label] = bucket_lanes.get(label, 0) + 1
            elif rec.status is TenantStatus.QUEUED:
                queued += 1
        lanes = int(svc.lanes_per_pack)
        payload: dict[str, Any] = {
            "member": self.index,
            "draining": self.draining,
            "retired": self.retired,
            "tenants": len(svc._tenants),
            "running": running,
            "queued": queued,
            "lanes_per_pack": lanes,
            "bucket_lanes": bucket_lanes,
            "free_lanes": {
                label: max(0, lanes - used)
                for label, used in sorted(bucket_lanes.items())
            },
            "queue_depth": {
                name: self.daemon._class_depth(name)
                for name in sorted(self.daemon.classes)
            },
            "segment_seconds": self.daemon._last_segment_seconds,
        }
        cache = self.daemon.exec_cache
        if cache is not None:
            hits = int(getattr(cache.stats, "hits", 0))
            misses = int(getattr(cache.stats, "misses", 0))
            payload["exec_cache"] = {
                "hits": hits,
                "misses": misses,
                "hit_rate": hits / (hits + misses) if (hits + misses) else None,
            }
        if self.daemon.slo is not None:
            try:
                payload["slo"] = self.daemon.slo.describe()
            except Exception as e:  # noqa: BLE001 - advisory, never fatal
                payload["slo"] = {"error": f"{type(e).__name__}: {e}"}
        return payload

    def fault_events(self) -> list[tuple[int, str]]:
        """Injected disk-fault events observed by this member's store
        (``(save_index, kind)`` pairs when the store is a
        :class:`~evox_tpu_torch.resilience.FaultyStore`; empty
        otherwise)."""
        return list(getattr(self.daemon.store, "events", ()))

    def load(self) -> int:
        """Scalar placement load: live work on this member (running +
        queued).  The router breaks ties toward the lowest index."""
        svc = self.daemon.service
        return sum(
            1
            for rec in list(svc._tenants.values())
            if rec.status in (TenantStatus.RUNNING, TenantStatus.QUEUED)
        )

    # -- the forward link ----------------------------------------------------
    # The exact request() shape FaultyTransport wraps: the router holds a
    # transport per member (default: the member itself) and every mutating
    # forward crosses it.
    def request(
        self,
        method: str,
        path: str,
        headers: Mapping[str, str] | None,
        body: bytes | None,
    ) -> tuple[int, dict[str, str], bytes]:
        """Serve one forwarded mutation.  Never raises: every failure is a
        structured JSON error reply (the transport layer above this —
        chaos injection — is what raises)."""
        try:
            status, payload = self._dispatch(method, path, body or b"")
        except AdmissionError as e:
            payload = {
                "error": e.reason,
                "detail": str(e),
                "retry_after_segments": e.retry_after_segments,
                "retry_after_seconds": e.retry_after_seconds,
            }
            status = _REASON_STATUS.get(e.reason, 400)
        except KeyError as e:
            status, payload = 404, {"error": "unknown-tenant", "detail": str(e)}
        except ValueError as e:
            status, payload = 400, {"error": "bad-request", "detail": str(e)}
        except RuntimeError as e:
            status, payload = 409, {"error": "conflict", "detail": str(e)}
        except Exception as e:  # noqa: BLE001 - a handler bug is a 500 reply
            status, payload = 500, {
                "error": type(e).__name__,
                "detail": str(e),
            }
        # Serving a forward IS a proof of life: refresh the beat (and the
        # capacity payload it carries) so a member busy capturing a burst
        # of submissions is not declared dead between scheduling rounds.
        try:
            self.beat()
        except Exception:  # noqa: BLE001 - liveness is advisory here
            pass
        return status, dict(_JSON_HEADERS), json.dumps(payload).encode("utf-8")

    def _dispatch(
        self, method: str, path: str, body: bytes
    ) -> tuple[int, dict[str, Any]]:
        if not path.startswith(MEMBER_API_PREFIX):
            return 404, {"error": "not-found", "detail": path}
        route = path[len(MEMBER_API_PREFIX):]
        if method == "GET" and route == "/capacity":
            return 200, self.capacity()
        if method != "POST":
            return 405, {"error": "method-not-allowed", "detail": method}
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"error": "bad-json", "detail": str(e)}
        if not isinstance(payload, dict):
            return 400, {"error": "bad-json", "detail": "body must be object"}
        if route == "/submit":
            return self._submit(payload)
        if route == "/steer":
            return self._steer(payload)
        if route == "/park":
            return self._park(payload)
        return 404, {"error": "not-found", "detail": path}

    def _submit(self, payload: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        blob = payload.get("spec")
        if not isinstance(blob, str):
            return 400, {"error": "bad-spec", "detail": "spec blob required"}
        try:
            spec = _decode_spec(blob, self.daemon.device)
        except Exception as e:  # noqa: BLE001 - hostile blob = 400 reply
            return 400, {"error": "bad-spec", "detail": str(e)}
        record = self.daemon.submit(
            spec,
            tenant_class=str(payload.get("tenant_class", "standard")),
            journal_extra=payload.get("journal_extra") or None,
        )
        return 201, {
            "tenant_id": record.spec.tenant_id,
            "uid": int(record.uid),
            "status": record.status.value,
        }

    def _steer(self, payload: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        tenant_id = str(payload.get("tenant_id", ""))
        knobs = self.daemon.steer(
            tenant_id,
            n_steps=payload.get("n_steps"),
            checkpoint_every=payload.get("checkpoint_every"),
            max_restarts=payload.get("max_restarts"),
            journal_extra=payload.get("journal_extra") or None,
        )
        return 200, {"tenant_id": tenant_id, "knobs": knobs}

    def _park(self, payload: dict[str, Any]) -> tuple[int, dict[str, Any]]:
        tenant_id = str(payload.get("tenant_id", ""))
        prior = self.daemon.park(tenant_id)
        record = self.daemon.tenant(tenant_id)
        return 200, {
            "tenant_id": tenant_id,
            "was": prior,
            "status": record.status.value,
        }
