"""Gateway client: retrying, idempotent, stdlib-only HTTP front-door SDK
(counterpart of ``evox_tpu/service/client.py``: the same wire, retry loop,
sleeps and errors).

The other half of :mod:`evox_tpu_torch.service.gateway`: a client whose retry
loop is **safe by construction** — every mutating call mints one
idempotency key per *logical operation* and reuses it across every
retry, so dropped requests, dropped replies, torn replies, and full
daemon SIGKILL+restart cycles all collapse to exactly-once admission on
the server (the key rides the journal).  The loop backs off
capped-exponentially on transport errors and honors ``Retry-After`` on
429/503, which means a fleet of these clients load-sheds itself by
exactly the daemon's live measured segment cadence.

Module import is stdlib-only (``http.client``, ``json``, ``uuid``) — a
bench or operator process pays no torch import (and makes no CUDA
context) to *talk* to a daemon; only :func:`encode_spec` (pickling an
actual :class:`TenantSpec` with ``torch.save``) touches the heavy stack,
lazily.

The transport seam is one method — ``request(method, path, headers,
body) -> (status, headers, body_bytes)`` — so
:class:`~evox_tpu_torch.resilience.FaultyTransport` can wrap
:class:`HttpTransport` and inject wire chaos between the retry loop and
the socket.  A reply whose JSON body fails to parse (torn reply) is
retried exactly like a dropped one: the ack the client finally returns
is always a whole, parsed, durable fact.
"""

from __future__ import annotations

import http.client
import json
import time
import uuid
from typing import Any, Callable
from urllib.parse import quote, urlparse

__all__ = ["GatewayClient", "GatewayError", "HttpTransport", "encode_spec"]

# Statuses that mean "try the same request again later"; everything else
# 4xx/5xx is a truthful terminal answer.
_RETRYABLE_STATUSES = frozenset({429, 503})


def encode_spec(spec: Any) -> dict[str, str]:
    """The wire form of an exact :class:`TenantSpec` —
    ``{"format": "pickle", "blob": <base64>}``, byte-identical to the
    daemon journal's own spec encoding (imported from it, not
    reimplemented), which is what makes an HTTP-submitted run
    bit-identical to a Python-submitted one.  A spec built on the CPU
    runs on the daemon's device: the daemon maps every tensor and every
    recorded ``torch.device`` there when it decodes the blob.

    Encoding a spec whose tensors live on the card copies them to the
    host: in a process that also serves, do it outside the serving
    thread's captures."""
    from .daemon import _encode_spec

    return {"format": "pickle", "blob": _encode_spec(spec)}


class GatewayError(RuntimeError):
    """A terminal (non-retryable, or retries-exhausted) API error.

    :ivar status: HTTP status code (0 when the wire itself gave out).
    :ivar error: the structured machine-readable code from the reply.
    :ivar retry_after: server back-off hint in seconds, when one came.
    """

    def __init__(
        self,
        status: int,
        error: str,
        detail: str,
        *,
        retry_after: float | None = None,
    ):
        super().__init__(f"[{status}] {error}: {detail}")
        self.status = int(status)
        self.error = str(error)
        self.detail = str(detail)
        self.retry_after = retry_after


class HttpTransport:
    """One-connection-per-request stdlib transport (deliberately simple:
    no pooling means no cross-request state for chaos to corrupt)."""

    def __init__(self, host: str, port: int, *, timeout: float = 35.0):
        self.host = str(host)
        self.port = int(port)
        self.timeout = float(timeout)

    def request(
        self,
        method: str,
        path: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, dict[str, str], bytes]:
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )
        try:
            conn.request(method, path, body=body or None, headers=headers)
            response = conn.getresponse()
            payload = response.read()
            return (
                int(response.status),
                {k: v for k, v in response.getheaders()},
                payload,
            )
        finally:
            conn.close()


class GatewayClient:
    """Front-door SDK for one principal.

    :param base_url: the endpoint base (``daemon.endpoint.url`` /
        ``gateway.url`` with or without the ``/api/v1`` suffix).
    :param token: the principal's bearer token.
    :param transport: the wire seam; defaults to :class:`HttpTransport`
        at ``base_url``'s host:port.  Tests wrap it in
        :class:`~evox_tpu_torch.resilience.FaultyTransport`.
    :param max_retries: retries *beyond* the first attempt for transport
        errors / torn replies / 429 / 503.  ``0`` = fail fast (the
        chaos tests use this to observe a lost ack, then retry by hand
        with the same key).
    :param backoff: initial retry sleep; doubles per retry up to
        ``backoff_cap`` (capped exponential — no jitter, so chaos
        schedules stay deterministic).
    :param retry_after_cap: ceiling on honoring a server ``Retry-After``
        (tests shrink it so a 1 s hint doesn't dominate the clock).
    :param sleep: injectable sleeper (tests pass a recorder).
    """

    def __init__(
        self,
        base_url: str,
        token: str,
        *,
        transport: Any | None = None,
        max_retries: int = 5,
        backoff: float = 0.05,
        backoff_cap: float = 2.0,
        retry_after_cap: float = 60.0,
        timeout: float = 35.0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        parsed = urlparse(base_url if "//" in base_url else f"//{base_url}")
        if not parsed.hostname or not parsed.port:
            raise ValueError(
                f"base_url must carry host:port, got {base_url!r}"
            )
        self.prefix = "/api/v1"
        self.token = str(token)
        self.transport = transport or HttpTransport(
            parsed.hostname, parsed.port, timeout=timeout
        )
        self.max_retries = int(max_retries)
        self.backoff = float(backoff)
        self.backoff_cap = float(backoff_cap)
        self.retry_after_cap = float(retry_after_cap)
        self.sleep = sleep
        self.retries = 0  # total retry sleeps taken (test observability)

    # -- API methods ---------------------------------------------------------
    def submit(
        self,
        spec: Any = None,
        *,
        catalog: dict[str, Any] | None = None,
        tenant_class: str = "standard",
        idem_key: str | None = None,
    ) -> dict[str, Any]:
        """Submit one tenant; returns the ack dict (``tenant_id``,
        ``uid``, ``status``).  Pass either a :class:`TenantSpec` (exact,
        bit-reproducible) or ``catalog=`` (the JSON form).  The
        idempotency key defaults to a fresh UUID reused across this
        call's retries; pass ``idem_key=`` to span retries across
        *client* restarts too."""
        if (spec is None) == (catalog is None):
            raise ValueError("pass exactly one of spec or catalog")
        body: dict[str, Any] = dict(catalog or {})
        if spec is not None:
            body["spec"] = encode_spec(spec)
        body["tenant_class"] = tenant_class
        return self._request(
            "POST",
            "/tenants",
            body=body,
            idem_key=idem_key or self.new_idem_key(),
        )

    def steer(
        self,
        tenant_id: str,
        *,
        n_steps: int | None = None,
        checkpoint_every: int | None = None,
        max_restarts: int | None = None,
        idem_key: str | None = None,
    ) -> dict[str, Any]:
        """Durably adjust a live tenant's budget/cadence/restart knobs
        (applies at the next segment boundary)."""
        body = {
            k: v
            for k, v in (
                ("n_steps", n_steps),
                ("checkpoint_every", checkpoint_every),
                ("max_restarts", max_restarts),
            )
            if v is not None
        }
        return self._request(
            "POST",
            f"/tenants/{quote(tenant_id, safe='')}/steer",
            body=body,
            idem_key=idem_key or self.new_idem_key(),
        )

    def withdraw(
        self, tenant_id: str, *, idem_key: str | None = None
    ) -> dict[str, Any]:
        return self._request(
            "DELETE",
            f"/tenants/{quote(tenant_id, safe='')}",
            idem_key=idem_key or self.new_idem_key(),
        )

    def status(self, tenant_id: str) -> dict[str, Any]:
        return self._request("GET", f"/tenants/{quote(tenant_id, safe='')}")

    def result(self, tenant_id: str, *, wait: float = 0.0) -> dict[str, Any]:
        """The tenant's result document; ``wait`` long-polls server-side.
        Raises :class:`GatewayError` with ``status=202`` semantics
        avoided — a still-running tenant returns its snapshot with
        ``status != "completed"``; check the field."""
        return self._request(
            "GET",
            f"/tenants/{quote(tenant_id, safe='')}/result?wait={float(wait)}",
            accept_statuses=(200, 202),
        )

    def result_npz(self, tenant_id: str) -> tuple[str, bytes]:
        """The newest checkpoint archive, raw: ``(name, bytes)`` — for
        client-side bit-identity verification."""
        status, headers, payload = self._raw(
            "GET",
            f"/tenants/{quote(tenant_id, safe='')}/result?format=npz",
        )
        if status != 200:
            raise self._error_from(status, headers, payload)
        name = ""
        for key, value in headers.items():
            if key.lower() == "x-checkpoint-name":
                name = value
        return name, payload

    def flight(
        self, tenant_id: str, *, after: int = -1, wait: float = 0.0
    ) -> list[dict[str, Any]]:
        reply = self._request(
            "GET",
            f"/tenants/{quote(tenant_id, safe='')}/flight"
            f"?after={int(after)}&wait={float(wait)}",
        )
        return list(reply.get("rows", []))

    @staticmethod
    def new_idem_key() -> str:
        return uuid.uuid4().hex

    # -- retry loop ----------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        *,
        body: dict[str, Any] | None = None,
        idem_key: str | None = None,
        accept_statuses: tuple[int, ...] = (200, 201),
    ) -> dict[str, Any]:
        payload = (
            json.dumps(body).encode("utf-8") if body is not None else b""
        )
        attempt = 0
        delay = self.backoff
        while True:
            retry_hint: float | None = None
            try:
                status, headers, reply = self._raw(
                    method,
                    path,
                    body=payload,
                    # Not a PRNG key: the idempotency token MUST repeat
                    # verbatim on every retry — reuse is the contract.
                    idem_key=idem_key,  # graftlint: disable=GL001
                )
                if status in accept_statuses:
                    return self._parse(reply)
                error = self._error_from(status, headers, reply)
                if status not in _RETRYABLE_STATUSES:
                    raise error
                retry_hint = error.retry_after
                failure: Exception = error
            except OSError as e:
                # Covers real socket errors, injected TransportError, and
                # _TornReply (all ConnectionError subclasses): the request
                # or its reply was lost or mangled — the idempotency key
                # is what makes the retry safe.
                failure = e
            if attempt >= self.max_retries:
                raise failure
            attempt += 1
            self.retries += 1
            pause = delay
            if retry_hint is not None:
                pause = max(pause, min(retry_hint, self.retry_after_cap))
            self.sleep(pause)
            delay = min(delay * 2.0, self.backoff_cap)

    def _raw(
        self,
        method: str,
        path: str,
        *,
        body: bytes = b"",
        idem_key: str | None = None,
    ) -> tuple[int, dict[str, str], bytes]:
        headers = {
            "Authorization": f"Bearer {self.token}",
            "Content-Type": "application/json",
        }
        if idem_key is not None:
            headers["Idempotency-Key"] = idem_key
        return self.transport.request(
            method, self.prefix + path, headers, body
        )

    @staticmethod
    def _parse(reply: bytes) -> dict[str, Any]:
        try:
            parsed = json.loads(reply.decode("utf-8"))
        except (ValueError, UnicodeDecodeError) as e:
            raise _TornReply(
                f"unparseable reply body ({e}); treating as lost"
            ) from e
        if not isinstance(parsed, dict):
            raise _TornReply(f"reply is not an object: {parsed!r}")
        return parsed

    def _error_from(
        self, status: int, headers: dict[str, str], reply: bytes
    ) -> GatewayError:
        error, detail = "http-error", reply.decode("utf-8", "replace")
        try:
            doc = json.loads(reply.decode("utf-8"))
            if isinstance(doc, dict):
                error = str(doc.get("error", error))
                detail = str(doc.get("detail", detail))
        except (ValueError, UnicodeDecodeError):
            pass
        retry_after: float | None = None
        for key, value in headers.items():
            if key.lower() == "retry-after":
                try:
                    retry_after = float(value)
                except ValueError:
                    pass
        return GatewayError(status, error, detail, retry_after=retry_after)


class _TornReply(ConnectionError):
    """A reply arrived but its body is not whole JSON — retryable, and
    only safe to retry because of idempotency keys."""
