"""Tenant model for the multi-tenant optimization service (counterpart of
``evox_tpu/service/tenant.py``).

A **tenant** is one independent optimization run a user submitted: an
algorithm configuration, a problem, a generation budget, and a stable
identity.  The service packs tenants whose segment program would be
identical — same algorithm class and static configuration, same
``(pop, dim)`` shape, same problem program — into one **bucket**, and steps
every tenant of a bucket as one vmapped segment, one captured CUDA graph on
the card (:class:`~evox_tpu_torch.service.TenantPack`).

Identity discipline (the bulkhead contract leans on it):

* ``uid`` — a stable non-negative integer, assigned at first submission and
  kept across eviction/readmission.  It seeds the tenant's random stream
  (``fold_in(service_key, uid)``: identity-keyed, never lane-keyed), it is
  the monitor ``instance_id`` every history entry carries, and it is the
  ``fault_lane`` value tenant-keyed chaos schedules match on.  Lane
  *position* is a placement detail that may change on every readmission and
  never influences a value.
* ``bucket_key`` — the program identity: two tenants share a bucket only
  when their algorithm/problem static configuration digests are equal, so
  one program is exact for every lane.  Over-splitting is always safe (a
  lonely tenant gets its own pack); under-splitting never happens
  silently.

The digests hash the port's objects: code by bytecode, names, constants
and closure (as the JAX package does), tensors by dtype, shape and bytes,
a ``torch.dtype`` or ``torch.device`` by its name.  They split buckets
where the JAX package's split them; the digests themselves differ.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any

import torch

__all__ = [
    "TenantSpec",
    "TenantStatus",
    "TenantRecord",
    "bucket_key",
    "static_signature",
    "validate_tenant_id",
]

#: Upper bound on tenant id length: the id is a directory component of the
#: checkpoint namespace and a flight-bundle path, and most filesystems cap
#: components at 255 bytes — leave room for ``ckpt_########.npz`` siblings
#: and principal prefixes.
MAX_TENANT_ID_LEN = 128


def validate_tenant_id(tenant_id: Any) -> str:
    """Validate one externally-supplied tenant id as a **safe path
    component** — the id names the tenant's checkpoint namespace directory
    (``<root>/tenants/<id>/``) and its flight-bundle paths, so this is the
    single choke point every id passes before it can touch a filesystem
    path (:class:`TenantSpec` construction and the service's
    :meth:`~evox_tpu_torch.service.OptimizationService.namespace`).

    Rejects (``ValueError``): non-strings, empty ids, anything outside
    ``[A-Za-z0-9._-]`` (separators, traversal slashes, ``%``-escapes,
    NULs...), the dot-only ids ``"."``/``".."``/``"..."``..., and ids
    longer than ``MAX_TENANT_ID_LEN``.  Returns the id unchanged."""
    if not isinstance(tenant_id, str) or not re.fullmatch(r"[A-Za-z0-9._-]+", tenant_id or ""):
        raise ValueError(
            f"tenant_id must be a non-empty [A-Za-z0-9._-] string (it "
            f"names the tenant's checkpoint namespace directory), got "
            f"{tenant_id!r}"
        )
    if set(tenant_id) == {"."}:
        raise ValueError(
            f"tenant_id {tenant_id!r} is a dot-only path component "
            f"('.'/'..' are directory navigation, not names)"
        )
    if len(tenant_id) > MAX_TENANT_ID_LEN:
        raise ValueError(
            f"tenant_id is {len(tenant_id)} chars; max is "
            f"{MAX_TENANT_ID_LEN} (it becomes a filesystem path component)"
        )
    return tenant_id


class TenantStatus(Enum):
    """Lifecycle of one tenant inside the service.

    ``QUEUED`` — admitted to the bounded queue, waiting for a lane.
    ``RUNNING`` — occupying a live pack lane.
    ``QUARANTINED`` — its lane is frozen (health verdict after the restart
    budget, or an in-segment early stop): the state stops evolving,
    cotenants are untouched, and the tenant stays resumable from its
    checkpoints.
    ``EVICTED`` — checkpointed to its namespace and removed from its lane
    (operator decision / preemption); readmission resumes bit-identically.
    ``COMPLETED`` — generation budget reached; final state retrievable.
    """

    QUEUED = "queued"
    RUNNING = "running"
    QUARANTINED = "quarantined"
    EVICTED = "evicted"
    COMPLETED = "completed"


@dataclass
class TenantSpec:
    """What a user submits: one independent optimization run (the JAX
    package's fields and checks).

    :param tenant_id: caller-chosen name; also the tenant's checkpoint
        namespace directory (a safe path component, see
        :func:`validate_tenant_id`).
    :param algorithm: the algorithm instance (its static configuration
        keys the bucket; evolving values live in per-tenant state).
    :param problem: the problem instance.  The FIRST tenant of a bucket
        donates the objects the bucket's program runs (the template);
        later tenants' objects must be configuration-equal (enforced via
        :func:`bucket_key`) and are used for bucketing only.
    :param n_steps: generation budget.  Generations advance in the
        service's fixed segment length, so completion lands on the first
        segment boundary at or past the budget (the same rounding for
        every tenant, solo or packed).
    :param uid: optional explicit stable identity (see the module
        docstring); auto-assigned by submission order when ``None``.
    :param workload: ``"standard"`` or ``"hpo"`` (a meta-optimization run:
        ``problem`` must be — or wrap — an
        :class:`~evox_tpu_torch.hpo.NestedProblem`, whose nested evaluate
        runs inside the pack's vmapped segment; the service keeps
        per-tenant ``evox_hpo_*`` metrics and, with ``grow=``, the
        elastic inner-population ladder).
    :param grow: optional :class:`~evox_tpu_torch.hpo.GrowthLadder` of an
        ``"hpo"`` tenant: when the service carries a
        :class:`~evox_tpu_torch.control.Controller`, stagnating inner runs
        fire journaled ``hpo-grow`` decisions that regrow this tenant's
        inner population and re-key it to the grown bucket.  Refused
        (``ValueError``) for a standard tenant, and for a window the
        nest's telemetry can never span.
    :param solution_transform: optional solution transform for the
        tenant's workflow; part of the bucket key (by code and closure).
    :param precision: optional
        :class:`~evox_tpu_torch.precision.PrecisionPolicy`; part of the
        bucket key.
    :param key_impl: optional random-stream family (``"rbg"``, ...); part
        of the bucket key, normalized at submission.
    """

    tenant_id: str
    algorithm: Any
    problem: Any
    n_steps: int
    uid: int | None = None
    workload: str = "standard"
    grow: Any = None
    solution_transform: Any = None
    precision: Any = None
    key_impl: str | None = None

    def __post_init__(self) -> None:
        validate_tenant_id(self.tenant_id)
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if self.uid is not None and self.uid < 0:
            raise ValueError(f"uid must be >= 0, got {self.uid}")
        if self.workload not in ("standard", "hpo"):
            raise ValueError(f"workload must be 'standard' or 'hpo', got {self.workload!r}")
        if self.workload == "hpo":
            # Duck-typed (the marker is NestedProblem's class attribute), so
            # wrapper chains, fault injection around the nest, stay
            # admissible.
            from ..hpo.nested import find_nested

            nested = find_nested(self.problem)
            if nested is None:
                raise ValueError(
                    "workload='hpo' needs a problem whose chain contains "
                    "an evox_tpu.hpo.NestedProblem (the fused nested "
                    "evaluate is what the HPO workload packs)"
                )
            if self.grow is not None:
                from ..hpo.elastic import validate_ladder_window

                validate_ladder_window(self.grow, nested)
        elif self.grow is not None:
            raise ValueError("grow= (the elastic inner-population ladder) only applies to workload='hpo' tenants")
        if self.key_impl is not None:
            from ..precision import resolve_key_impl

            # Normalize at submission so the bucket key and every stream
            # derivation agree on one canonical name.
            self.key_impl = resolve_key_impl(self.key_impl)


@dataclass
class TenantRecord:
    """The service's runtime record of one tenant (host-side bookkeeping;
    every evolving *value* lives in the tenant's lane state)."""

    spec: TenantSpec
    uid: int
    status: TenantStatus = TenantStatus.QUEUED
    bucket: tuple | None = None
    lane: int | None = None
    generations: int = 0
    restarts: int = 0
    # Elastic inner-population growths applied to an HPO tenant (the
    # deterministic-regrow salt index; bounded by the service's
    # max_restarts budget alongside restarts).
    grows: int = 0
    segments_since_checkpoint: int = 0
    # Human-readable lifecycle trail: admissions, verdicts, restarts,
    # evictions — the per-tenant analogue of RunStats.failures.
    events: list[str] = field(default_factory=list)
    monitor: Any | None = None
    result: Any | None = None
    # Per-tenant flight recorder (``FlightRecorder.for_tenant``), fed from
    # the pack's lane-demuxed flight telemetry.
    flight: Any | None = None
    # Per-tenant scheduling-knob overrides (``max_restarts`` /
    # ``checkpoint_every``) shadowing the service-wide values.
    steer: dict[str, int] = field(default_factory=dict)


def _hash_code(h: "hashlib._Hash", code: Any) -> None:
    """Digest of a code object's behavior: bytecode, names and constants
    (two functions differing only in a string constant share their
    ``co_code``), recursing into nested code objects."""
    h.update(code.co_code)
    h.update(repr(code.co_names).encode())
    for const in code.co_consts:
        if hasattr(const, "co_code"):
            _hash_code(h, const)
        else:
            h.update(repr(const).encode())


def _hash_value(h: "hashlib._Hash", value: Any) -> None:
    if isinstance(value, (bool, int, float, str, bytes, type(None))):
        h.update(repr(value).encode())
    elif isinstance(value, (torch.dtype, torch.device)):
        # Their names: a float32 and a bfloat16 template, or a CPU and a
        # CUDA one, are different programs.
        h.update(type(value).__name__.encode())
        h.update(str(value).encode())
    elif callable(value) and hasattr(value, "__code__"):
        # Plain functions: qualified name + code digest + closure
        # contents, so two tenants with different transforms never share
        # a bucket, while a re-import of the same function hashes alike.
        h.update(getattr(value, "__qualname__", "<fn>").encode())
        _hash_code(h, value.__code__)
        for cell in value.__closure__ or ():
            try:
                _hash_value(h, cell.cell_contents)
            except ValueError:  # empty cell
                h.update(b"<empty-cell>")
    elif isinstance(value, (tuple, list, frozenset, set)):
        h.update(b"(")
        for item in sorted(value, key=repr) if isinstance(value, (set, frozenset)) else value:
            _hash_value(h, item)
        h.update(b")")
    elif isinstance(value, dict):
        h.update(b"{")
        for k in sorted(value, key=repr):
            _hash_value(h, k)
            _hash_value(h, value[k])
        h.update(b"}")
    elif isinstance(value, torch.Tensor):
        # dtype, shape and bytes (read on the host: a submission is a
        # host-side event).
        t = value.detach()
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    elif hasattr(value, "dtype") and hasattr(value, "shape"):
        import numpy as np

        arr = np.asarray(value)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    elif hasattr(value, "__dict__") or hasattr(value, "evaluate") or hasattr(value, "step"):
        # Nested component (a problem wrapper chain, an inner optimizer):
        # recurse into its static configuration.
        h.update(type(value).__name__.encode())
        _hash_attrs(h, value)
    else:
        # Opaque object: type identity only.
        h.update(type(value).__name__.encode())


# Runtime-volatile component attributes that must not split buckets (or
# drift a tenant's bucket between submissions): flags the workflow sets,
# host-side fault counters.
_VOLATILE_ATTRS = frozenset({"in_sharded_program", "in_fused_program", "deadline_trips"})


def _hash_attrs(h: "hashlib._Hash", obj: Any) -> None:
    attrs = getattr(obj, "__dict__", None)
    if not attrs:
        return
    for name in sorted(attrs):
        if name.startswith("_") or name in _VOLATILE_ATTRS:
            continue
        h.update(name.encode())
        _hash_value(h, attrs[name])


def static_signature(obj: Any) -> str:
    """Digest of a component's static (public, non-volatile)
    configuration — attribute names and values, tensors by bytes, nested
    components recursively.  Two components with equal signatures run the
    same program modulo the values that live in per-tenant state."""
    h = hashlib.sha256()
    h.update(type(obj).__name__.encode())
    _hash_attrs(h, obj)
    return h.hexdigest()


def bucket_key(spec: TenantSpec) -> tuple:
    """The program bucket a tenant belongs to: algorithm class +
    ``(pop, dim)`` + the static-configuration digests of algorithm,
    problem, and solution transform, plus the tenant's numerics identity
    (precision policy and key implementation).  Tenants sharing a key are
    safe to step through ONE program with per-tenant state."""
    from ..precision import precision_identity, resolve_key_impl

    algo = spec.algorithm
    if spec.solution_transform is None:
        transform = "no-transform"
    else:
        h = hashlib.sha256()
        _hash_value(h, spec.solution_transform)
        transform = h.hexdigest()
    return (
        type(algo).__name__,
        int(getattr(algo, "pop_size", 0)),
        int(getattr(algo, "dim", 0)),
        type(spec.problem).__name__,
        static_signature(algo),
        static_signature(spec.problem),
        transform,
        precision_identity(spec.precision),
        resolve_key_impl(spec.key_impl),
    )
