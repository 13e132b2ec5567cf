"""Deterministic network chaos for the gateway wire: FaultyTransport
(counterpart of ``evox_tpu/resilience/transport.py``, a copy: the port
imports nothing of the JAX package, and the events, request counts, torn
bytes and validation messages are the JAX package's).

:class:`FaultyTransport` is the wire-side twin of
:class:`~evox_tpu_torch.resilience.FaultyStore`: it wraps any client transport
(an object with ``request(method, path, headers, body) -> (status,
headers, body_bytes)`` — :class:`~evox_tpu_torch.service.client.HttpTransport`
in practice) and injects faults by **request index** (0-based count of
requests routed through this instance), the same scheduling idiom
FaultyProblem uses for eval faults and FaultyStore for save faults.

The faults model the four ways a network loses a request/reply pair, and
they matter differently on each side of the journal append:

* ``drop_requests`` — the request is never delivered: the wrapped
  transport is **not** called, :class:`TransportError` is raised.  No
  server-side effect; a retry is trivially safe.
* ``drop_replies`` — the request **is** delivered (the wrapped transport
  runs to completion, so the server appended its journal record and sent
  an ack) but the reply is discarded and :class:`TransportError` is
  raised.  This is the post-append/pre-reply crash window seen from the
  client: the only thing that makes the client's retry safe is the
  idempotency key riding the journal.
* ``torn_replies`` — the reply body is truncated to ``torn_fraction`` of
  its bytes (a connection reset mid-body).  The client sees a parse
  failure and must treat it exactly like a dropped reply.
* ``duplicate_requests`` — the request is delivered **twice** (retransmit
  of a packet the server already processed); the second reply is
  returned.  The server must dedup — one admission, two acks.
* ``delay_requests`` — the request sleeps ``delay_seconds`` before
  delivery (congestion; exercises client timeouts and long-poll overlap).

Request indices count *attempts through this wrapper*: a dropped request
still consumes its index, so "the retry succeeds" schedules naturally.
``events`` records one ``(index, kind)`` tuple per fired fault and
``requests`` counts attempts, for test assertions.

Stdlib-only; no torch import (the client side of the wire must stay cheap
to spawn in a separate process).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Sequence

from .schedule import validate_schedule

__all__ = ["FaultyTransport", "TransportError"]


class TransportError(ConnectionError):
    """A request or reply was lost on the wire (injected or real).

    Subclasses :class:`ConnectionError` so client retry loops that catch
    ``OSError`` — the base of every real socket failure — handle injected
    chaos through the same path as the real thing.
    """


class FaultyTransport:
    """Wrap a transport and lose/duplicate/tear/delay scheduled requests.

    :param inner: the real transport; anything with
        ``request(method, path, headers, body)``.
    :param drop_requests: request indices never delivered (inner not
        called; :class:`TransportError`).
    :param drop_replies: request indices delivered but whose reply is
        discarded (:class:`TransportError` *after* the inner call — the
        server-side effect happened).
    :param torn_replies: request indices whose reply body is truncated
        to ``torn_fraction`` of its bytes.
    :param duplicate_requests: request indices delivered twice
        back-to-back; the second reply wins.
    :param delay_requests: request indices delayed ``delay_seconds``
        before delivery.
    """

    def __init__(
        self,
        inner: Any,
        *,
        drop_requests: Sequence[int] = (),
        drop_replies: Sequence[int] = (),
        torn_replies: Sequence[int] = (),
        torn_fraction: float = 0.5,
        duplicate_requests: Sequence[int] = (),
        delay_requests: Sequence[int] = (),
        delay_seconds: float = 0.05,
    ):
        # Construction-time audit, the FaultyProblem discipline: negative
        # request indices and one request scheduled for two incompatible
        # fates (a never-delivered request has no reply to drop, tear, or
        # duplicate; a dropped reply is never observed torn) fail loudly
        # here, never lazily mid-run.
        schedules = validate_schedule(
            "FaultyTransport",
            indices={
                "drop_requests": drop_requests,
                "drop_replies": drop_replies,
                "torn_replies": torn_replies,
                "duplicate_requests": duplicate_requests,
                "delay_requests": delay_requests,
            },
            nonneg={
                "torn_fraction": float(torn_fraction),
                "delay_seconds": float(delay_seconds),
            },
            exclusive=[
                ("drop_requests", "drop_replies"),
                ("drop_requests", "torn_replies"),
                ("drop_requests", "duplicate_requests"),
                ("drop_replies", "torn_replies"),
            ],
        )
        self.inner = inner
        self.drop_requests = schedules["drop_requests"]
        self.drop_replies = schedules["drop_replies"]
        self.torn_replies = schedules["torn_replies"]
        self.torn_fraction = float(torn_fraction)
        self.duplicate_requests = schedules["duplicate_requests"]
        self.delay_requests = schedules["delay_requests"]
        self.delay_seconds = float(delay_seconds)
        self._lock = threading.Lock()
        self.requests = 0  # attempts routed through this wrapper
        self.events: list[tuple[int, str]] = []

    def request(
        self,
        method: str,
        path: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, dict[str, str], bytes]:
        with self._lock:
            index = self.requests
            self.requests += 1
        if index in self.delay_requests:
            with self._lock:
                self.events.append((index, "delay"))
            time.sleep(self.delay_seconds)
        if index in self.drop_requests:
            with self._lock:
                self.events.append((index, "drop-request"))
            raise TransportError(
                f"injected: request #{index} {method} {path} never delivered"
            )
        status, reply_headers, reply_body = self.inner.request(
            method, path, headers, body
        )
        if index in self.duplicate_requests:
            with self._lock:
                self.events.append((index, "duplicate-request"))
            status, reply_headers, reply_body = self.inner.request(
                method, path, headers, body
            )
        if index in self.drop_replies:
            with self._lock:
                self.events.append((index, "drop-reply"))
            raise TransportError(
                f"injected: reply to #{index} {method} {path} lost "
                f"(server already processed the request)"
            )
        if index in self.torn_replies:
            with self._lock:
                self.events.append((index, "torn-reply"))
            keep = max(1, int(len(reply_body) * self.torn_fraction))
            reply_body = reply_body[:keep]
        return status, reply_headers, reply_body
