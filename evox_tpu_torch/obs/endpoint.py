"""Live introspection endpoint: read-only HTTP over the telemetry plane
(counterpart of ``evox_tpu/obs/endpoint.py``, a copy: stdlib only, the
same routes, status codes and bodies for the same providers).

Recorded telemetry — metrics, events, flight rings, decision journals —
is otherwise only reachable by tailing files on the serving host.  :class:`IntrospectionEndpoint` puts a read-only stdlib
``http.server`` in front of it, on its own daemon thread, with the one
non-negotiable contract: **the endpoint can never touch the serving
path**.  Every provider call is exception-guarded (a broken provider is
a 500 response, not a crashed daemon), the server thread is a daemon
(never blocks process exit), and nothing here takes a lock the scheduler
holds across a boundary.

Routes (all ``GET``, all read-only):

* ``/metrics`` — Prometheus text exposition (fleet-aggregated when the
  owner wires a :class:`evox_tpu.obs.FleetAggregator`, process-local
  otherwise).
* ``/healthz`` — liveness + per-host verdicts as JSON; **non-200 (503)
  when unhealthy**, so a supervisor, load balancer, or k8s probe can
  act on the status code alone.
* ``/statusz`` — one JSON document of live scheduler state: tenants,
  per-class queue depths, decision-journal tail, exec-cache hit rates
  (the :class:`evox_tpu.service.ServiceDaemon` wires this).
* ``/flightz/<tenant_id>`` — the tenant's flight-recorder ring window as
  JSON rows (404 for unknown tenants / no recorder).

One optional **write** surface rides the same port: every request under
``/api/`` (any method — the gateway uses POST/DELETE/GET) is delegated
verbatim to the ``api=`` callable when one is wired
(:class:`evox_tpu_torch.service.Gateway` is the only in-package owner).  The
endpoint stays transport only: it reads the bounded request body, hands
``(method, raw_path, headers, body)`` over, and writes back whatever
``(status, content_type, body, extra_headers)`` comes out — routing,
auth, idempotency, and journal ordering are entirely the API handler's
contract.  Without ``api=``, ``/api/...`` is a 404 like any other
unknown path and the server remains read-only GET.

Providers are plain callables so any owner — daemon, fleet supervisor, a
bare script — wires exactly the surface it has.  ``port=0`` binds an
OS-assigned port (tests); the bound port is readable at ``.port`` after
:meth:`start`.

Stdlib-only at import, like the whole obs package.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import unquote, urlparse

from .metrics import MetricsRegistry

__all__ = ["IntrospectionEndpoint"]

# Largest request body /api/ accepts.  A pickled TenantSpec for any
# realistic population is a few KiB; 8 MiB leaves room for large catalog
# payloads while bounding what an unauthenticated peer can make a
# handler thread buffer.
MAX_API_BODY = 8 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    """One request.  All routing lives here; the endpoint instance rides
    on the server object.  Exceptions anywhere become a 500 — a broken
    provider must never take the serving process with it."""

    # Request lines from slow/portscanning clients must not wedge a
    # handler thread forever.
    timeout = 10.0
    protocol_version = "HTTP/1.1"

    def log_message(self, format: str, *args: Any) -> None:  # noqa: A002
        pass  # scrapes are high-frequency; stderr spam helps nobody

    def do_POST(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler contract
        self._write_method("POST")

    def do_DELETE(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler contract
        self._write_method("DELETE")

    def _write_method(self, method: str) -> None:
        """POST/DELETE exist only for the ``/api/`` surface."""
        endpoint: "IntrospectionEndpoint" = self.server.endpoint  # type: ignore[attr-defined]
        try:
            path = urlparse(self.path).path
            endpoint._count(path)
            if path.startswith("/api/") and endpoint.api is not None:
                self._api(endpoint, method)
            elif path.startswith("/api/"):
                self._respond(
                    404,
                    "application/json",
                    json.dumps({"error": "no api handler wired"}),
                )
            else:
                self._respond(
                    405,
                    "application/json",
                    json.dumps({"error": f"{method} only serves /api/ paths"}),
                )
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 - fail-safe by contract
            try:
                self._respond(
                    500,
                    "application/json",
                    json.dumps({"error": f"{type(e).__name__}: {e}"}),
                )
            except Exception:  # pragma: no cover - socket already gone
                pass

    def do_GET(self) -> None:  # noqa: N802 - BaseHTTPRequestHandler contract
        endpoint: "IntrospectionEndpoint" = self.server.endpoint  # type: ignore[attr-defined]
        try:
            path = urlparse(self.path).path
            endpoint._count(path)
            if path.startswith("/api/") and endpoint.api is not None:
                self._api(endpoint, "GET")
            elif path == "/metrics":
                self._metrics(endpoint)
            elif path == "/healthz":
                self._healthz(endpoint)
            elif path == "/statusz":
                self._statusz(endpoint)
            elif path.startswith("/flightz/"):
                self._flightz(endpoint, unquote(path[len("/flightz/") :]))
            elif path in ("/", ""):
                self._respond(
                    200,
                    "text/plain; charset=utf-8",
                    "evox_tpu introspection: /metrics /healthz /statusz "
                    "/flightz/<tenant_id>\n",
                )
            else:
                self._respond(
                    404, "application/json", json.dumps({"error": "not found"})
                )
        except BrokenPipeError:  # client went away mid-response
            pass
        except Exception as e:  # noqa: BLE001 - fail-safe by contract
            try:
                self._respond(
                    500,
                    "application/json",
                    json.dumps({"error": f"{type(e).__name__}: {e}"}),
                )
            except Exception:  # pragma: no cover - socket already gone
                pass

    # -- routes --------------------------------------------------------------
    def _api(self, endpoint: "IntrospectionEndpoint", method: str) -> None:
        """Delegate one ``/api/`` request to the wired API handler.

        The handler owns routing/auth/journal ordering; this side only
        enforces the transport bounds (body size) and the reply shape.
        """
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except (TypeError, ValueError):
            length = -1
        if length < 0 or length > MAX_API_BODY:
            self._respond(
                413,
                "application/json",
                json.dumps(
                    {"error": f"request body must be 0..{MAX_API_BODY} bytes"}
                ),
            )
            return
        body = self.rfile.read(length) if length else b""
        status, content_type, payload, extra = endpoint.api(  # type: ignore[misc]
            method, self.path, dict(self.headers.items()), body
        )
        self._respond(int(status), str(content_type), payload, extra)

    def _metrics(self, endpoint: "IntrospectionEndpoint") -> None:
        provider = endpoint.metrics
        if provider is None:
            self._respond(
                404,
                "application/json",
                json.dumps({"error": "no metrics provider wired"}),
            )
            return
        self._respond(
            200, "text/plain; version=0.0.4; charset=utf-8", str(provider())
        )

    def _healthz(self, endpoint: "IntrospectionEndpoint") -> None:
        provider = endpoint.healthz
        if provider is None:
            # No health provider = nothing known to be wrong: liveness of
            # the endpoint thread itself is the (weak) signal.
            self._respond(
                200, "application/json", json.dumps({"healthy": True})
            )
            return
        healthy, payload = provider()
        body = dict(payload or {})
        body.setdefault("healthy", bool(healthy))
        self._respond(
            200 if healthy else 503, "application/json", json.dumps(body)
        )

    def _statusz(self, endpoint: "IntrospectionEndpoint") -> None:
        provider = endpoint.statusz
        if provider is None:
            self._respond(
                404,
                "application/json",
                json.dumps({"error": "no statusz provider wired"}),
            )
            return
        self._respond(
            200,
            "application/json",
            json.dumps(provider(), default=repr),
        )

    def _flightz(self, endpoint: "IntrospectionEndpoint", tenant_id: str) -> None:
        provider = endpoint.flight
        if provider is None or not tenant_id:
            self._respond(
                404,
                "application/json",
                json.dumps({"error": "no flight provider wired"}),
            )
            return
        rows = provider(tenant_id)
        if rows is None:
            self._respond(
                404,
                "application/json",
                json.dumps(
                    {"error": f"no flight window for tenant {tenant_id!r}"}
                ),
            )
            return
        self._respond(
            200,
            "application/json",
            json.dumps({"tenant_id": tenant_id, "rows": list(rows)}),
        )

    def _respond(
        self,
        status: int,
        content_type: str,
        body: str | bytes,
        extra_headers: dict[str, str] | None = None,
    ) -> None:
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Cache-Control", "no-store")
        for name, value in (extra_headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(data)


class IntrospectionEndpoint:
    """Read-only HTTP introspection server on a daemon thread.

    :param metrics: callable returning the Prometheus text body for
        ``/metrics`` (a registry's ``to_prometheus``, an aggregator's);
        ``registry=`` is the shorthand for the common case.
    :param healthz: callable returning ``(healthy, payload_dict)`` for
        ``/healthz``; unhealthy responds 503.  ``None`` = always 200.
    :param statusz: callable returning the JSON-serializable ``/statusz``
        document.
    :param flight: callable mapping a tenant id to its flight-ring rows
        (a list of dicts) or ``None`` (404) for ``/flightz/<tenant_id>``.
    :param api: callable serving every ``/api/...`` request (any method):
        ``(method, raw_path, headers, body_bytes) -> (status,
        content_type, body_str_or_bytes, extra_headers_or_None)``.  The
        raw path keeps its query string.  ``None`` (default) leaves the
        server read-only GET.
    :param registry: shorthand: wires ``metrics`` to this registry's
        ``to_prometheus`` when no explicit ``metrics`` callable is given.
    :param instrument: optional registry the endpoint counts its own
        scrapes into (``evox_endpoint_requests_total{path=}``) — pass
        the process registry so scrape traffic is itself observable.
    :param host: bind address (default loopback; introspection is
        unauthenticated — exposing it wider is a deployment decision).
    :param port: TCP port; ``0`` (default) = OS-assigned, readable at
        ``.port`` after :meth:`start`.
    """

    def __init__(
        self,
        *,
        metrics: Callable[[], str] | None = None,
        healthz: Callable[[], tuple[bool, Any]] | None = None,
        statusz: Callable[[], Any] | None = None,
        flight: Callable[[str], Any] | None = None,
        api: Callable[
            [str, str, dict[str, str], bytes],
            tuple[int, str, "str | bytes", "dict[str, str] | None"],
        ]
        | None = None,
        registry: MetricsRegistry | None = None,
        instrument: MetricsRegistry | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        if metrics is None and registry is not None:
            metrics = registry.to_prometheus
        self.metrics = metrics
        self.healthz = healthz
        self.statusz = statusz
        self.flight = flight
        self.api = api
        self.instrument = instrument
        self.host = str(host)
        self._requested_port = int(port)
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "IntrospectionEndpoint":
        """Bind and serve on a daemon thread (idempotent); returns self."""
        if self._server is not None:
            return self
        server = ThreadingHTTPServer(
            (self.host, self._requested_port), _Handler
        )
        server.daemon_threads = True  # a wedged handler never blocks exit
        server.endpoint = self  # type: ignore[attr-defined]
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="evox-tpu-introspection",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the server down and release the port (idempotent)."""
        server, self._server = self._server, None
        thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def started(self) -> bool:
        return self._server is not None

    @property
    def port(self) -> int:
        """The bound port (the requested one before :meth:`start`)."""
        if self._server is not None:
            return int(self._server.server_address[1])
        return self._requested_port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- internals -----------------------------------------------------------
    def _count(self, path: str) -> None:
        if self.instrument is None:
            return
        try:
            # Only the known routes mint label values: /flightz/<id>
            # collapses to one, and everything else — 404 probes, port
            # scanners — collapses to "other".  Arbitrary request paths
            # as label values would grow immortal series without bound.
            if path.startswith("/flightz"):
                label = "/flightz"
            elif path.startswith("/api"):
                label = "/api"
            elif path in ("/metrics", "/healthz", "/statusz", "/", ""):
                label = path or "/"
            else:
                label = "other"
            self.instrument.counter(
                "evox_endpoint_requests_total",
                "Introspection endpoint requests served, by path.",
                path=label,
            ).inc()
        except Exception:  # pragma: no cover - broken registry
            pass
