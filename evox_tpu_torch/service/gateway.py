"""Network front door: authenticated, crash-safe write API on the wire
(counterpart of ``evox_tpu/service/gateway.py``: the same routes, status
codes, error codes, JSON bodies, idempotency map and counters).

The daemon's HTTP plane (:class:`~evox_tpu_torch.obs.IntrospectionEndpoint`)
is read-only introspection.  :class:`Gateway` adds the write half —
submit, steer, withdraw, fetch — on the **same** endpoint plane (one port,
one server thread pool), built to the same survive-anything standard as
the journal underneath it:

* **Ack-after-append, on the wire.**  Every mutating reply is sent only
  after the daemon's journal append fsync'd: a client that holds a 2xx
  holds a durable fact.  A daemon killed before the append never
  admitted anything; one killed after the append but before the reply
  *did* — which is exactly why the next bullet exists.
* **Exactly-once admission via idempotency keys.**  Mutating requests
  carry an ``Idempotency-Key`` header (required on submit, honored on
  steer/withdraw); the key rides the journal record itself
  (``journal_extra``), so :meth:`Gateway.start` rebuilds the dedup map
  from replay and a client retrying one key across a daemon
  SIGKILL+restart gets the original ack back (``200``, with
  ``"idempotent_replay": true``) instead of a second admission.  Keys
  are namespaced per principal — two tenants cannot collide each other's
  retries.
* **Auth namespaces the filesystem.**  ``Authorization: Bearer <token>``
  maps to a *principal*; every externally-supplied tenant id is
  validated as a safe path component (:func:`validate_tenant_id` — the
  hostile-id 400), then qualified as ``<principal>--<tenant_id>`` before
  it touches the daemon, so checkpoint namespaces
  (``<root>/tenants/<principal>--<id>/``) and flight bundles are
  per-principal by construction and one principal can neither see nor
  collide another's tenants (cross-principal reads are 404, not 403 —
  existence is not leaked).
* **Overload speaks HTTP.**  ``AdmissionError(reason="shed")`` maps to
  429 and ``"queue-full"``/``"journal-failed"`` to 503, both with a
  ``Retry-After`` header computed from the **live measured** segment
  cadence (:func:`~evox_tpu_torch.service.retry_after_seconds` — the same
  helper that fills ``stats.rejections``), so a dumb HTTP client backs
  off by exactly the hint the Python API gets.

Wire surface (all under ``/api/v1``, all JSON unless noted)::

    POST   /api/v1/tenants                submit (201; idem replay 200)
    DELETE /api/v1/tenants/<id>           withdraw/park (evict record)
    POST   /api/v1/tenants/<id>/steer     journaled steer record
    GET    /api/v1/tenants/<id>           status snapshot
    GET    /api/v1/tenants/<id>/result    ?wait=S long-poll; ?format=npz
                                          streams the newest checkpoint
    GET    /api/v1/tenants/<id>/flight    ?after=G&wait=S flight-ring rows

Submit bodies name the spec either as the exact Python object
(``{"spec": {"format": "pickle", "blob": "<base64>"}}`` — what
:class:`~evox_tpu_torch.service.client.GatewayClient` sends; byte-identical
to the journal's own spec encoding, which is what makes HTTP-submitted
runs bit-identical to Python-submitted ones) or as a small JSON catalog
form (``{"algorithm": {"kind": "PSO", ...}, "problem": {"kind":
"Ackley"}, ...}``) for curl-level clients.  Pickle deserialization is
gated behind authentication by design — a bearer token is operator-level
trust here.

The gateway fronts either one daemon or a whole fleet: a
:class:`~evox_tpu_torch.service.TenantRouter` answers the same surface
(``Gateway(router, tokens=...)``), and its ``placement`` records carry
the idempotency keys the dedup map is rebuilt from.

**The device.**  The gateway serves whatever device its daemon runs on
(the card by default).  A pickled spec may have been built on the CPU or
on the card; either way it runs on ``daemon.device``, bit-equal to the
same spec built there (the daemon's decoder maps every storage and every
recorded ``torch.device``).  A router's ``device`` is the host: a spec
stays there until the member that owns it decodes it onto the card.

Threading: endpoint handler threads call :meth:`handle` concurrently
with the serving loop.  One :class:`threading.RLock` (``gateway.lock``)
serializes every **mutating** route with the daemon's boundary rounds —
:meth:`pump`/:meth:`serve` take it per round, so a submit never lands
mid-boundary.  Read routes (status/result/flight) take it only for the
snapshot instant, never across a long-poll sleep.  Between two rounds
the serving loop waits until every handler thread already queued on the
lock has taken it, so a request waits one boundary at most (the JAX
package's loop takes the lock straight back, and on the card a queued
steer waited out a whole batch of rounds).  On the card the lock
has a second duty: the serving thread captures CUDA graphs inside
``daemon.step()`` and ``daemon.submit()`` (a new bucket's programs), and
while a capture is open CUDA refuses every other thread's allocation or
synchronous copy (and the refused call invalidates the capture).  So no
handler thread touches the card outside the lock: a submitted spec is
decoded and validated on the CPU first (a hostile blob gets its 400
without the lock), and reaches ``daemon.device`` only under it; the
catalog form's bounds are built on the device only under it; a result's
history rows leave the card (``.cpu()``) under it.

Chaos story: :class:`~evox_tpu_torch.resilience.FaultyTransport` injects
dropped/duplicated/torn/delayed requests and replies on the client seam,
and ``tests/test_torch_gateway.py`` drives the kill-at-every-boundary
matrix entirely through HTTP — the acceptance bar is bit-identical final
state, monitor history, and checkpoint leaf digests versus the same specs
submitted via the Python API.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import threading
import time
from dataclasses import replace as dataclass_replace
from typing import Any, Callable
from urllib.parse import parse_qs, unquote, urlparse

import torch

from ..obs.endpoint import IntrospectionEndpoint
from ..obs.slo import SIGNAL_GATEWAY
from .service import AdmissionError, retry_after_seconds
from .tenant import TenantStatus, validate_tenant_id

__all__ = ["Gateway", "PRINCIPAL_SEP"]

#: Separator between the authenticated principal and the caller's tenant
#: id in the qualified (daemon-side) id.  Both halves are validated
#: ``[A-Za-z0-9._-]+`` and the principal may not contain the separator,
#: so the split is unambiguous and the joined id stays a safe path
#: component.
PRINCIPAL_SEP = "--"

# Long-poll waits are capped: a handler thread parked forever on a
# never-completing tenant would pin server threads without bound.
MAX_WAIT_SECONDS = 30.0
_POLL_SECONDS = 0.05
# The longest a serving loop waits between two rounds for the handler
# threads already queued on the lock to take it.
_HANDOFF_SECONDS = 5.0

_JSON = "application/json"

# Where a submitted spec is decoded first, outside the gateway lock.
_HOST = torch.device("cpu")


def _on(factory: Any, device: torch.device) -> dict[str, Any]:
    """``{"device": device}`` when ``factory`` takes a ``device`` keyword
    (or any keyword), else nothing: a catalog kind whose constructor
    names no device is built as the JAX package builds it."""
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):
        return {}
    takes = any(
        p.name == "device" or p.kind is inspect.Parameter.VAR_KEYWORD
        for p in params
    )
    return {"device": device} if takes else {}


class _ApiError(Exception):
    """One structured HTTP error reply: ``(status, error, detail)``."""

    def __init__(
        self,
        status: int,
        error: str,
        detail: str,
        *,
        retry_after: float | None = None,
    ):
        super().__init__(detail)
        self.status = int(status)
        self.error = str(error)
        self.detail = str(detail)
        self.retry_after = retry_after


class Gateway:
    """The write API, attached to a daemon's introspection endpoint.

    :param daemon: the :class:`~evox_tpu_torch.service.ServiceDaemon` to front
        (on its own device: the gateway adds no device option).
        When it already has an endpoint the gateway rides it (one port
        serves both planes); otherwise a loopback OS-assigned-port
        endpoint is created and wired to the daemon's own providers.
    :param tokens: ``{bearer_token: principal}`` — the auth table.
        Principals are validated as safe path components and may not
        contain ``"--"`` (the qualification separator).  Two tokens may
        map to one principal (key rotation).
    :param host: bind address when the gateway must create the endpoint.
    :param port: TCP port ditto (``0`` = OS-assigned).

    Call :meth:`start` before serving: it starts the daemon (journal
    replay), rebuilds the idempotency dedup map from the replayed
    records, and starts the HTTP server.  Then either drive boundaries
    yourself under ``gateway.lock`` or call :meth:`pump`/:meth:`serve`.
    """

    def __init__(
        self,
        daemon: Any,
        *,
        tokens: dict[str, str],
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        if not tokens:
            raise ValueError(
                "tokens must name at least one bearer token -> principal "
                "(an unauthenticated write API is not a configuration)"
            )
        for token, principal in tokens.items():
            if not token or not isinstance(token, str):
                raise ValueError("bearer tokens must be non-empty strings")
            validate_tenant_id(principal)
            if PRINCIPAL_SEP in principal:
                raise ValueError(
                    f"principal {principal!r} contains {PRINCIPAL_SEP!r} "
                    f"(the principal/tenant separator must stay unambiguous)"
                )
        self.daemon = daemon
        self.tokens = dict(tokens)
        #: Serializes mutating routes with serving-loop boundaries; hold
        #: it around any daemon.step() you drive yourself.
        self.lock = threading.RLock()
        # Handler threads queued on the lock: pump/serve let them in
        # between two rounds (see _let_handlers_in).
        self._waiting = 0
        self._turn = threading.Condition(threading.Lock())
        self._idem: dict[str, dict[str, Any]] = {}
        self._requests: dict[tuple[str, int], int] = {}
        self._auth_rejects = 0
        self._idem_replays = 0
        self._retry_after_sent = 0
        self._started = False
        # An attached ChaosConductor registers itself here; the gateway
        # statusz section then carries the live run's chaos strip too.
        self.chaos: Any | None = None
        if daemon.endpoint is None:
            daemon.endpoint = IntrospectionEndpoint(
                metrics=daemon._metrics_text,
                healthz=daemon._healthz,
                statusz=daemon._statusz,
                flight=daemon._flight_window,
                instrument=daemon._registry,
                api=self.handle,
                host=host,
                port=port,
            )
        else:
            daemon.endpoint.api = self.handle
        daemon.gateway = self

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Gateway":
        """Start daemon (journal replay) + endpoint, rebuild the
        idempotency map from the replayed journal (idempotent)."""
        if self._started:
            return self
        with self.lock:
            self.daemon.start()
            self._rebuild_idem()
            if not self.daemon.endpoint.started:
                self.daemon.endpoint.start()
            self._started = True
        return self

    def _rebuild_idem(self) -> None:
        """Exactly-once across restarts: every journaled mutating record
        carries its idempotency key (``journal_extra``), so a second,
        read-only replay rebuilds the dedup map the in-memory half lost
        with the killed process.  Later records win (a resubmit after a
        retire is a fresh admission under a fresh key).

        Compaction-safe: a snapshot-anchored journal folds pre-anchor
        dedup entries into the snapshot's ``idem`` map (the daemon fold
        mirrors this exact entry shape), so a client retry straddling a
        compaction still replays its ack instead of double-admitting."""
        try:
            records, _damage = self.daemon.journal.replay()
        except Exception:  # pragma: no cover - replay already warned
            return
        snapshot = self.daemon.journal.snapshot_state or {}
        for token, entry in (snapshot.get("idem") or {}).items():
            self._idem[str(token)] = dict(entry)
        for rec in records:
            key = rec.data.get("idem")
            principal = rec.data.get("principal")
            if not key or not principal:
                continue
            self._idem[f"{principal}:{key}"] = {
                "route": rec.kind,
                "tenant_id": rec.data.get("tenant_id"),
                "uid": rec.data.get("uid"),
                "knobs": {
                    k: rec.data[k]
                    for k in ("n_steps", "checkpoint_every", "max_restarts")
                    if rec.kind == "steer" and k in rec.data
                },
            }

    @property
    def url(self) -> str:
        return f"{self.daemon.endpoint.url}/api/v1"

    def close(self) -> None:
        self.daemon.close()

    # -- serving loop --------------------------------------------------------
    def pump(self, max_rounds: int | None = None) -> int:
        """Drive daemon boundaries under the gateway lock; returns the
        number of rounds executed (stops early when the daemon goes
        idle).  The lock is released between rounds, so mutating HTTP
        requests interleave at exactly boundary granularity."""
        self.start()
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            with self.lock:
                busy = self.daemon.step()
            rounds += 1
            if not busy:
                break
            self._let_handlers_in()
        return rounds

    def serve(
        self,
        *,
        stop: Callable[[], bool] | None = None,
        idle_sleep: float = 0.05,
    ) -> None:
        """Run boundaries until ``stop()`` goes truthy, sleeping
        ``idle_sleep`` whenever the daemon reports idle (submissions
        arriving over HTTP wake it on the next round)."""
        self.start()
        while stop is None or not stop():
            with self.lock:
                busy = self.daemon.step()
            if not busy:
                if stop is None:
                    break
                time.sleep(idle_sleep)
            else:
                self._let_handlers_in()

    def _let_handlers_in(self) -> None:
        """Between two rounds, wait until every handler thread already
        queued on ``gateway.lock`` has taken it (bounded by
        ``_HANDOFF_SECONDS``).  A lock released and taken again at once by
        the serving thread would starve them: on the card a round is a
        graph replay, and a queued submit or steer waited out many rounds
        (a whole batch), where the contract is one boundary."""
        with self._turn:
            self._turn.wait_for(lambda: self._waiting == 0, timeout=_HANDOFF_SECONDS)

    @contextlib.contextmanager
    def _hold(self):
        """``gateway.lock`` for a handler thread, queued where the
        serving loop sees it (:meth:`_let_handlers_in`)."""
        with self._turn:
            self._waiting += 1
        try:
            self.lock.acquire()
        finally:
            with self._turn:
                self._waiting -= 1
                self._turn.notify_all()
        try:
            yield
        finally:
            self.lock.release()

    # -- the one entry point (endpoint api= seam) ----------------------------
    def handle(
        self,
        method: str,
        raw_path: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, str, "str | bytes", "dict[str, str] | None"]:
        """Serve one ``/api/...`` request; never raises (the endpoint
        would 500 — here even a handler bug becomes structured JSON)."""
        route = "other"
        try:
            parsed = urlparse(raw_path)
            query = {
                k: v[-1] for k, v in parse_qs(parsed.query).items() if v
            }
            principal = self._authenticate(headers)
            route, reply = self._route(
                method, parsed.path, query, headers, body, principal
            )
            self._observe(route, reply[0])
            return reply
        except _ApiError as e:
            self._observe(route, e.status)
            extra: dict[str, str] | None = None
            if e.retry_after is not None:
                extra = {"Retry-After": str(max(1, math.ceil(e.retry_after)))}
                self._retry_after_sent += 1
            body_out = json.dumps(
                {
                    "error": e.error,
                    "detail": e.detail,
                    **(
                        {"retry_after_seconds": float(e.retry_after)}
                        if e.retry_after is not None
                        else {}
                    ),
                }
            )
            return e.status, _JSON, body_out, extra
        except Exception as e:  # noqa: BLE001 - fail-safe by contract
            self._observe(route, 500)
            return (
                500,
                _JSON,
                json.dumps(
                    {"error": "internal", "detail": f"{type(e).__name__}: {e}"}
                ),
                None,
            )

    # -- auth ----------------------------------------------------------------
    def _authenticate(self, headers: dict[str, str]) -> str:
        auth = ""
        for name, value in headers.items():
            if name.lower() == "authorization":
                auth = value.strip()
                break
        if not auth.startswith("Bearer "):
            self._auth_rejects += 1
            self._inc("evox_gateway_auth_rejects_total")
            raise _ApiError(
                401,
                "unauthenticated",
                "missing 'Authorization: Bearer <token>' header",
            )
        principal = self.tokens.get(auth[len("Bearer ") :].strip())
        if principal is None:
            self._auth_rejects += 1
            self._inc("evox_gateway_auth_rejects_total")
            raise _ApiError(401, "unauthenticated", "unknown bearer token")
        return principal

    def _qualify(self, principal: str, tenant_id: Any) -> str:
        try:
            validate_tenant_id(tenant_id)
        except ValueError as e:
            raise _ApiError(400, "bad-tenant-id", str(e)) from e
        return f"{principal}{PRINCIPAL_SEP}{tenant_id}"

    def _resolve(self, principal: str, tenant_id: str) -> Any:
        """A principal's tenant record; 404 for anything else —
        including other principals' live ids (no existence leak)."""
        qualified = self._qualify(principal, tenant_id)
        record = self.daemon.service._tenants.get(qualified)
        if record is None:
            raise _ApiError(
                404, "unknown-tenant", f"no tenant {tenant_id!r}"
            )
        return record

    # -- routing -------------------------------------------------------------
    def _route(
        self,
        method: str,
        path: str,
        query: dict[str, str],
        headers: dict[str, str],
        body: bytes,
        principal: str,
    ) -> tuple[str, tuple[int, str, "str | bytes", "dict[str, str] | None"]]:
        prefix = "/api/v1/tenants"
        if path == prefix or path == prefix + "/":
            if method != "POST":
                raise _ApiError(405, "method", f"{method} not allowed here")
            return "submit", self._submit(principal, headers, body)
        if not path.startswith(prefix + "/"):
            raise _ApiError(404, "not-found", f"no route {path!r}")
        rest = [unquote(p) for p in path[len(prefix) + 1 :].split("/") if p]
        if not rest:
            raise _ApiError(404, "not-found", f"no route {path!r}")
        tenant_id, action = rest[0], (rest[1] if len(rest) > 1 else None)
        if len(rest) > 2:
            raise _ApiError(404, "not-found", f"no route {path!r}")
        if action is None and method == "DELETE":
            return "withdraw", self._withdraw(principal, tenant_id, headers)
        if action is None and method == "GET":
            return "status", self._status(principal, tenant_id)
        if action == "steer" and method == "POST":
            return "steer", self._steer(principal, tenant_id, headers, body)
        if action == "result" and method == "GET":
            return "result", self._result(principal, tenant_id, query)
        if action == "flight" and method == "GET":
            return "flight", self._flight(principal, tenant_id, query)
        raise _ApiError(
            405 if action in (None, "steer", "result", "flight") else 404,
            "method" if action in (None, "steer", "result", "flight") else "not-found",
            f"{method} {path!r} is not part of the API",
        )

    # -- idempotency ---------------------------------------------------------
    def _idem_key(
        self, principal: str, headers: dict[str, str], *, required: bool
    ) -> str | None:
        for name, value in headers.items():
            if name.lower() == "idempotency-key" and value.strip():
                return f"{principal}:{value.strip()}"
        if required:
            raise _ApiError(
                400,
                "missing-idempotency-key",
                "submit requires an 'Idempotency-Key' header: it is what "
                "makes your retries exactly-once across daemon restarts",
            )
        return None

    def _idem_replay(
        self, key: str | None
    ) -> tuple[int, str, str, None] | None:
        if key is None:
            return None
        ack = self._idem.get(key)
        if ack is None:
            return None
        self._idem_replays += 1
        self._inc("evox_gateway_idem_replays_total")
        qualified = ack.get("tenant_id") or ""
        record = self.daemon.service._tenants.get(qualified)
        payload = {
            "idempotent_replay": True,
            "route": ack.get("route"),
            "tenant_id": self._unqualify(qualified),
            "uid": ack.get("uid"),
        }
        if ack.get("knobs"):
            payload["knobs"] = ack["knobs"]
        if record is not None:
            payload["status"] = record.status.value
            payload["generations"] = int(record.generations)
        return 200, _JSON, json.dumps(payload), None

    @staticmethod
    def _unqualify(qualified: str) -> str:
        head, sep, tail = qualified.partition(PRINCIPAL_SEP)
        return tail if sep else qualified

    # -- mutating routes -----------------------------------------------------
    def _submit(
        self, principal: str, headers: dict[str, str], body: bytes
    ) -> tuple[int, str, str, "dict[str, str] | None"]:
        key = self._idem_key(principal, headers, required=True)
        payload = self._json_body(body)
        # Decoded and validated on the host, outside the lock: a hostile
        # or malformed spec gets its 400 here and no handler thread
        # touches the card while the serving thread may be capturing.
        spec = self._decode_submit_spec(payload, _HOST)
        qualified = self._qualify(principal, spec.tenant_id)
        spec = dataclass_replace(spec, tenant_id=qualified)
        tenant_class = str(payload.get("tenant_class", "standard"))
        with self._hold():
            replay = self._idem_replay(key)
            if replay is not None:
                return replay
            if self.daemon.device != _HOST:
                spec = dataclass_replace(
                    self._decode_submit_spec(payload, self.daemon.device),
                    tenant_id=qualified,
                )
            try:
                record = self.daemon.submit(
                    spec,
                    tenant_class=tenant_class,
                    journal_extra={"idem": key.split(":", 1)[1], "principal": principal},
                )
            except AdmissionError as e:
                raise self._admission_error(e) from e
            except ValueError as e:
                raise _ApiError(400, "bad-spec", str(e)) from e
            self._idem[key] = {
                "route": "submit",
                "tenant_id": qualified,
                "uid": record.uid,
            }
            return (
                201,
                _JSON,
                json.dumps(
                    {
                        "tenant_id": self._unqualify(qualified),
                        "uid": int(record.uid),
                        "status": record.status.value,
                        "tenant_class": tenant_class,
                    }
                ),
                None,
            )

    def _steer(
        self,
        principal: str,
        tenant_id: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, str, str, "dict[str, str] | None"]:
        key = self._idem_key(principal, headers, required=False)
        payload = self._json_body(body)
        kwargs = {
            k: payload[k]
            for k in ("n_steps", "checkpoint_every", "max_restarts")
            if payload.get(k) is not None
        }
        with self._hold():
            replay = self._idem_replay(key)
            if replay is not None:
                return replay
            record = self._resolve(principal, tenant_id)
            extra = (
                {"idem": key.split(":", 1)[1], "principal": principal}
                if key is not None
                else None
            )
            try:
                knobs = self.daemon.steer(
                    record.spec.tenant_id, journal_extra=extra, **kwargs
                )
            except ValueError as e:
                raise _ApiError(400, "bad-steer", str(e)) from e
            except RuntimeError as e:
                raise _ApiError(409, "not-steerable", str(e)) from e
            except AdmissionError as e:
                raise self._admission_error(e) from e
            if key is not None:
                self._idem[key] = {
                    "route": "steer",
                    "tenant_id": record.spec.tenant_id,
                    "uid": record.uid,
                    "knobs": knobs,
                }
            return (
                200,
                _JSON,
                json.dumps(
                    {
                        "tenant_id": tenant_id,
                        "uid": int(record.uid),
                        "knobs": knobs,
                        "applies": "next segment boundary",
                    }
                ),
                None,
            )

    def _withdraw(
        self, principal: str, tenant_id: str, headers: dict[str, str]
    ) -> tuple[int, str, str, "dict[str, str] | None"]:
        key = self._idem_key(principal, headers, required=False)
        with self._hold():
            replay = self._idem_replay(key)
            if replay is not None:
                return replay
            record = self._resolve(principal, tenant_id)
            try:
                prior = self.daemon.park(record.spec.tenant_id)
            except RuntimeError as e:
                raise _ApiError(409, "not-withdrawable", str(e)) from e
            except AdmissionError as e:
                raise self._admission_error(e) from e
            if key is not None:
                # park() journals an "evict" record without extra fields;
                # the in-memory map still dedups same-process retries, and
                # a post-restart retry of an already-parked tenant gets a
                # truthful 409 (the ack's content, minus the 2xx).
                self._idem[key] = {
                    "route": "withdraw",
                    "tenant_id": record.spec.tenant_id,
                    "uid": record.uid,
                }
            return (
                200,
                _JSON,
                json.dumps(
                    {
                        "tenant_id": tenant_id,
                        "uid": int(record.uid),
                        "was": prior,
                        "status": record.status.value,
                    }
                ),
                None,
            )

    # -- read routes ---------------------------------------------------------
    def _status(
        self, principal: str, tenant_id: str
    ) -> tuple[int, str, str, None]:
        with self._hold():
            record = self._resolve(principal, tenant_id)
            payload = self._snapshot(tenant_id, record)
        return 200, _JSON, json.dumps(payload), None

    def _snapshot(self, tenant_id: str, record: Any) -> dict[str, Any]:
        return {
            "tenant_id": tenant_id,
            "uid": int(record.uid),
            "status": record.status.value,
            "generations": int(record.generations),
            "n_steps": int(record.spec.n_steps),
            "restarts": int(record.restarts),
            "steer": dict(record.steer),
        }

    def _result(
        self, principal: str, tenant_id: str, query: dict[str, str]
    ) -> tuple[int, str, "str | bytes", "dict[str, str] | None"]:
        deadline = time.monotonic() + self._wait(query)
        while True:
            with self._hold():
                record = self._resolve(principal, tenant_id)
                done = record.status is TenantStatus.COMPLETED
                snapshot = self._snapshot(tenant_id, record)
            if done or time.monotonic() >= deadline:
                break
            time.sleep(_POLL_SECONDS)
        if query.get("format") == "npz":
            return self._result_npz(principal, tenant_id, record)
        if not done:
            return 202, _JSON, json.dumps(snapshot), None
        with self._hold():
            history = []
            if record.monitor is not None:
                # Under the lock: a row on the card is copied to the host.
                history = [
                    torch.as_tensor(row).detach().cpu().tolist()
                    for row in getattr(record.monitor, "fitness_history", [])
                ]
            snapshot = self._snapshot(tenant_id, record)
        name, digests = self._checkpoint_digests(record)
        snapshot.update(
            {
                "fitness_history": history,
                "checkpoint": name,
                "leaf_digests": digests,
            }
        )
        return 200, _JSON, json.dumps(snapshot), None

    def _result_npz(
        self, principal: str, tenant_id: str, record: Any
    ) -> tuple[int, str, bytes, "dict[str, str] | None"]:
        """The newest checkpoint archive, raw — the client verifies
        bit-identity against a local run from these exact bytes."""
        ns = self.daemon.service.namespace(record.spec.tenant_id)
        names = (
            sorted(p.name for p in ns.glob("*.npz")) if ns.is_dir() else []
        )
        if not names:
            raise _ApiError(
                404,
                "no-checkpoint",
                f"tenant {tenant_id!r} has no published checkpoint yet",
            )
        newest = ns / names[-1]
        return (
            200,
            "application/octet-stream",
            newest.read_bytes(),
            {"X-Checkpoint-Name": names[-1]},
        )

    def _checkpoint_digests(
        self, record: Any
    ) -> tuple[str | None, dict[str, str] | None]:
        from ..utils.checkpoint import read_manifest

        ns = self.daemon.service.namespace(record.spec.tenant_id)
        names = (
            sorted(p.name for p in ns.glob("*.npz")) if ns.is_dir() else []
        )
        if not names:
            return None, None
        try:
            manifest = read_manifest(ns / names[-1])
            return names[-1], dict(manifest.get("leaf_digests") or {})
        except Exception:  # noqa: BLE001 - a torn file is a read-path 404
            return names[-1], None

    def _flight(
        self, principal: str, tenant_id: str, query: dict[str, str]
    ) -> tuple[int, str, str, None]:
        try:
            after = int(query.get("after", -1))
        except ValueError as e:
            raise _ApiError(400, "bad-query", f"after must be an int: {e}")
        deadline = time.monotonic() + self._wait(query)
        while True:
            with self._hold():
                record = self._resolve(principal, tenant_id)
                if record.flight is None:
                    raise _ApiError(
                        404,
                        "no-flight",
                        f"tenant {tenant_id!r} has no flight recorder "
                        f"armed (construct the daemon with "
                        f"obs=Observability(flight=FlightRecorder(...)))",
                    )
                rows = [
                    row
                    for row in record.flight.rows()
                    if row.get("generation", 0) > after
                ]
            if rows or time.monotonic() >= deadline:
                break
            time.sleep(_POLL_SECONDS)
        return (
            200,
            _JSON,
            json.dumps({"tenant_id": tenant_id, "after": after, "rows": rows}),
            None,
        )

    # -- request plumbing ----------------------------------------------------
    @staticmethod
    def _wait(query: dict[str, str]) -> float:
        try:
            wait = float(query.get("wait", 0.0))
        except ValueError as e:
            raise _ApiError(400, "bad-query", f"wait must be seconds: {e}")
        return max(0.0, min(wait, MAX_WAIT_SECONDS))

    @staticmethod
    def _json_body(body: bytes) -> dict[str, Any]:
        if not body:
            return {}
        try:
            payload = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _ApiError(400, "bad-json", f"request body: {e}") from e
        if not isinstance(payload, dict):
            raise _ApiError(400, "bad-json", "request body must be an object")
        return payload

    def _decode_submit_spec(
        self, payload: dict[str, Any], device: torch.device
    ) -> Any:
        """The submitted spec, with every tensor on ``device``."""
        from .daemon import _decode_spec

        spec_field = payload.get("spec")
        if isinstance(spec_field, dict):
            if spec_field.get("format") != "pickle":
                raise _ApiError(
                    400,
                    "bad-spec",
                    f"unknown spec format {spec_field.get('format')!r} "
                    f"(only 'pickle' — or use the JSON catalog form)",
                )
            try:
                return _decode_spec(str(spec_field.get("blob", "")), device)
            except Exception as e:  # noqa: BLE001 - hostile blob = 400
                raise _ApiError(
                    400, "bad-spec", f"undecodable spec blob: {e}"
                ) from e
        if "algorithm" in payload and "problem" in payload:
            return self._catalog_spec(payload, device)
        raise _ApiError(
            400,
            "bad-spec",
            "submit body needs either {'spec': {'format': 'pickle', "
            "'blob': ...}} or the JSON catalog form "
            "({'algorithm': {...}, 'problem': {...}, 'tenant_id', 'n_steps'})",
        )

    def _catalog_spec(
        self, payload: dict[str, Any], device: torch.device
    ) -> Any:
        """Build a TenantSpec on ``device`` from the curl-friendly JSON
        catalog form: algorithm/problem classes named out of the public
        registries (``evox_tpu_torch.algorithms.__all__`` /
        ``problems.numerical.__all__`` — a whitelist, not ``getattr`` on
        arbitrary modules).  The algorithm and the problem are built on
        ``device`` when their constructors take one."""
        from .. import algorithms
        from ..problems import numerical
        from .tenant import TenantSpec

        alg_cfg = dict(payload["algorithm"])
        prob_cfg = dict(payload["problem"])
        alg_kind = str(alg_cfg.pop("kind", ""))
        prob_kind = str(prob_cfg.pop("kind", ""))
        if alg_kind not in getattr(algorithms, "__all__", ()):
            raise _ApiError(
                400, "bad-spec", f"unknown algorithm kind {alg_kind!r}"
            )
        if prob_kind not in getattr(numerical, "__all__", ()):
            raise _ApiError(
                400, "bad-spec", f"unknown problem kind {prob_kind!r}"
            )
        try:
            pop_size = int(alg_cfg.pop("pop_size"))
            dim = int(alg_cfg.pop("dim"))
            lb = torch.full((dim,), float(alg_cfg.pop("lb")), device=device)
            ub = torch.full((dim,), float(alg_cfg.pop("ub")), device=device)
            algorithm_cls = getattr(algorithms, alg_kind)
            problem_cls = getattr(numerical, prob_kind)
            algorithm = algorithm_cls(
                pop_size, lb, ub, **alg_cfg, **_on(algorithm_cls, device)
            )
            problem = problem_cls(**prob_cfg, **_on(problem_cls, device))
            return TenantSpec(
                str(payload.get("tenant_id", "")),
                algorithm,
                problem,
                n_steps=int(payload.get("n_steps", 0)),
                uid=(
                    None if payload.get("uid") is None else int(payload["uid"])
                ),
            )
        except _ApiError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise _ApiError(
                400, "bad-spec", f"catalog spec: {type(e).__name__}: {e}"
            ) from e

    # -- error + telemetry ---------------------------------------------------
    def _admission_error(self, e: AdmissionError) -> _ApiError:
        seconds = e.retry_after_seconds
        if seconds is None:
            seconds = retry_after_seconds(
                e.retry_after_segments, self.daemon._last_segment_seconds
            )
        status = {
            "shed": 429,
            "queue-full": 503,
            "journal-failed": 503,
            # Router (TenantRouter) refusals: the placement decision is
            # journaled, so a retry lands exactly once — all retryable.
            "member-link": 503,
            "member-down": 503,
            "no-members": 503,
            "id-collision": 409,
            "uid-collision": 409,
            "uid-mismatch": 409,
        }.get(e.reason, 400)
        return _ApiError(
            status,
            e.reason,
            str(e),
            retry_after=seconds if status in (429, 503) else None,
        )

    def _observe(self, route: str, code: int) -> None:
        self._requests[(route, int(code))] = (
            self._requests.get((route, int(code)), 0) + 1
        )
        self._inc(
            "evox_gateway_requests_total",
            "Gateway API requests served, by route and status code.",
            route=route,
            code=str(int(code)),
        )
        slo = getattr(self.daemon, "slo", None)
        if slo is not None:
            try:
                # 4xx is a good event: the service answered correctly.
                slo.record(SIGNAL_GATEWAY, code < 500)
            except Exception:  # pragma: no cover - tracker misconfig
                pass

    def _inc(self, name: str, help: str = "", **labels: str) -> None:
        registry = self.daemon._registry
        if registry is None:
            return
        try:
            registry.counter(name, help, **labels).inc()
        except Exception:  # pragma: no cover - broken registry
            pass

    def statusz_payload(self) -> dict[str, Any]:
        """The ``/statusz`` ``gateway`` section (read-only, fail-safe):
        request/error/retry-after/idempotency counters plus live tenant
        counts per principal (split off the qualified ids)."""
        principals: dict[str, int] = {}
        for tid in list(self.daemon.service._tenants):
            head, sep, _tail = tid.partition(PRINCIPAL_SEP)
            if sep:
                principals[head] = principals.get(head, 0) + 1
        payload = {
            "requests": {
                f"{route}:{code}": n
                for (route, code), n in sorted(self._requests.items())
            },
            "errors": sum(
                n for (_r, code), n in self._requests.items() if code >= 400
            ),
            "auth_rejects": self._auth_rejects,
            "idem_replays": self._idem_replays,
            "retry_after_sent": self._retry_after_sent,
            "idem_keys": len(self._idem),
            "principals": principals,
        }
        if self.chaos is not None:
            try:
                payload["chaos"] = self.chaos.statusz_payload()
            except Exception as e:  # noqa: BLE001 - read-only, fail-safe
                payload["chaos"] = {"error": f"{type(e).__name__}: {e}"}
        return payload
