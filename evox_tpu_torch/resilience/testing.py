"""Public chaos-test scaffolding: the ONE definition of the
kill-at-every-boundary matrices and the bit-identity comparators
(counterpart of ``evox_tpu/resilience/testing.py``).

* :func:`kill_points` — the canonical SIGKILL boundaries per serving
  plane.  SIGKILL is always modelled as **abandonment**: the object is
  dropped with no shutdown path running (exactly what SIGKILL guarantees —
  no handler, no flush, no destructor) and a fresh instance is rebuilt
  over the same root.
* :func:`assert_states_equal` / :func:`npify` — bit-identity over the
  port's state pytrees: every leaf compares by dtype, shape and raw bytes,
  so key tensors compare by their words and NaNs by their bits.
* :func:`last_checkpoint_digests` / :func:`verify_tenants_bit_identical`
  — the checkpoint-digest compare and the shared tail of every kill
  matrix: each tenant COMPLETED with final state and newest-checkpoint
  leaf digests bit-identical to an uninterrupted reference run.
* :func:`flip_bit` — single-bit on-disk corruption (the signature SHA-256
  leaf digests exist for).
* :func:`silent` / :func:`run_silently` — run a callable/daemon with
  warnings muted (chaos runs *warn loudly* by design; the tests assert
  the recovery outcome, not the noise).

Imported explicitly (``from evox_tpu_torch.resilience.testing import
...``), as in the JAX package: it is no part of the lean
``evox_tpu_torch.resilience`` namespace.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Any, Mapping, Union

import numpy as np
import torch

from ..utils.checkpoint import _named_leaves, read_manifest

__all__ = [
    "KILL_POINTS",
    "kill_points",
    "npify",
    "assert_states_equal",
    "last_checkpoint_digests",
    "verify_tenants_bit_identical",
    "flip_bit",
    "silent",
    "run_silently",
]

#: The canonical kill-at-every-boundary matrices, one entry per serving
#: plane (the JAX package's tuples).  Each name is a lifecycle point a
#: SIGKILL lands at; every plane's acceptance test parametrizes over its
#: tuple.
KILL_POINTS: dict[str, tuple[str, ...]] = {
    # ServiceDaemon lifecycle (the daemon's kill-restart matrix).
    "daemon": (
        "post-submit-pre-journal-ack",
        "post-ack-pre-admit",
        "mid-run",
        "post-checkpoint",
    ),
    # Gateway HTTP lifecycle: the same daemon boundaries as seen from the
    # wire, where the pre/post journal split becomes pre-append vs
    # post-append/pre-reply.
    "gateway": (
        "pre-append",
        "post-append-pre-reply",
        "mid-run",
        "post-checkpoint",
    ),
    # TenantRouter submit path (the router's forward-boundary matrix).
    "router": (
        "pre-journal",
        "post-journal-pre-forward",
        "post-forward-pre-ack",
    ),
}


def kill_points(plane: str) -> tuple[str, ...]:
    """The canonical SIGKILL boundaries for one serving plane
    (``"daemon"`` / ``"gateway"`` / ``"router"``)."""
    try:
        return KILL_POINTS[plane]
    except KeyError:
        raise ValueError(f"unknown plane {plane!r}; kill matrices exist for {sorted(KILL_POINTS)}") from None


def npify(x: Any) -> np.ndarray:
    """One leaf to a comparable host array: a tensor's values on the host
    (bfloat16 as its ``uint16`` words, keys as their int64 words),
    anything else through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def assert_states_equal(a: Any, b: Any, context: str = "") -> None:
    """Bit-identity over two state pytrees, leaf by leaf (dtype, shape and
    raw bytes); an ``AssertionError`` names the first differing leaf
    path."""
    leaves_a = list(_named_leaves(a))
    leaves_b = [t for _, t in _named_leaves(b)]
    # Explicit raises (not bare asserts): these verdicts must survive
    # ``python -O``.
    if len(leaves_a) != len(leaves_b):
        raise AssertionError(f"{context}: leaf count differs ({len(leaves_a)} != {len(leaves_b)})")
    for (path, la), lb in zip(leaves_a, leaves_b):
        if not _same_bits(npify(la), npify(lb)):
            raise AssertionError(f"{context}: leaf {path} differs")


def last_checkpoint_digests(root: Union[str, Path], tenant_id: str) -> tuple[str, dict[str, str]]:
    """(newest checkpoint filename, its manifest's per-leaf SHA-256
    digests) for one tenant namespace — the durable half of the
    bit-identity compare."""
    ns = os.path.join(str(root), "tenants", tenant_id)
    newest = sorted(f for f in os.listdir(ns) if f.endswith(".npz"))[-1]
    manifest = read_manifest(os.path.join(ns, newest))
    return newest, manifest["leaf_digests"]


def verify_tenants_bit_identical(
    daemon: Any,
    root: Union[str, Path],
    expected: Mapping[str, Any],
    expected_digests: Mapping[str, tuple[str, dict[str, str]]],
    context: str = "",
) -> None:
    """The shared tail of every kill matrix: each expected tenant is
    COMPLETED on ``daemon`` with result state and newest-checkpoint leaf
    digests bit-identical to the uninterrupted reference run."""
    from ..service import TenantStatus

    for tenant_id in expected:
        record = daemon.tenant(tenant_id)
        if record.status is not TenantStatus.COMPLETED:
            raise AssertionError(f"{context}: {tenant_id} is {record.status}, not COMPLETED")
        assert_states_equal(expected[tenant_id], daemon.result(tenant_id), f"{context}: {tenant_id}")
        name, digests = last_checkpoint_digests(root, tenant_id)
        if (name, digests) != tuple(expected_digests[tenant_id]):
            raise AssertionError(f"{context}: {tenant_id} final checkpoint digests differ")


def flip_bit(path: Union[str, Path], offset: int | None = None) -> None:
    """Flip one bit of a file in place (mid-file by default): bit rot
    that ``np.load`` reads back without complaint — the case per-leaf
    SHA-256 digests exist for."""
    path = Path(path)
    raw = bytearray(path.read_bytes())
    raw[(len(raw) // 2) if offset is None else offset] ^= 0x01
    # Deliberately non-atomic, in place: this helper exists to model the
    # torn/bit-rotted publish the store seam defends against.
    path.write_bytes(bytes(raw))


def silent(fn: Any, *args: Any, **kwargs: Any) -> Any:
    """Call ``fn`` with all warnings muted; returns its result."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kwargs)


def run_silently(steppable: Any, *args: Any, **kwargs: Any) -> None:
    """``steppable.run(...)`` with all warnings muted (daemons warn loudly
    through injected chaos, by design)."""
    silent(steppable.run, *args, **kwargs)
