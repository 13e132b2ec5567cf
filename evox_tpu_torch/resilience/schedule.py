"""Construction-time fault-schedule audit: :func:`validate_schedule`
(counterpart of ``evox_tpu/resilience/schedule.py``, a copy: the port
imports nothing of the JAX package).

One helper behind every injector's loud-failure contract:
:class:`~evox_tpu_torch.resilience.FaultyStore` routes through here, so a
malformed fault plan — a negative index, an index scheduled for two
incompatible fates, an unknown field — raises a ``ValueError`` naming the
field at construction, never a silent no-op or a confusing failure deep
inside the run it was meant to orchestrate.  Messages are the JAX
package's, string for string.

Stdlib-only.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

__all__ = ["validate_schedule"]


def validate_schedule(
    name: str,
    *,
    indices: Mapping[str, Any] | None = None,
    nonneg: Mapping[str, float] | None = None,
    exclusive: Sequence[tuple[str, str]] = (),
    fields: Mapping[str, Any] | None = None,
    known: Sequence[str] | None = None,
) -> dict[str, frozenset]:
    """Audit one fault plan at construction time.

    :param name: the injector/plan name, for error messages.
    :param indices: ``{field: iterable-of-ints}`` 0-based schedules; a
        negative index raises.  Returns each as a ``frozenset`` so
        constructors can assign the normalized form directly.
    :param nonneg: ``{field: scalar}`` parameters that must be ``>= 0``.
    :param exclusive: pairs of schedule fields whose index sets must not
        overlap — one attempt cannot take two fates (a save cannot both
        crash pre-publish and tear its published bytes; a request cannot
        be both never-delivered and have its reply dropped; a member
        cannot be SIGKILLed inside its own partition window).
    :param fields: a plan dict to check for unknown keys against
        ``known`` (the DSL-ingestion path; omit for plain constructors).
    :param known: the complete set of valid field names for ``fields``.
    :returns: ``{field: frozenset(int)}`` for every entry of ``indices``.
    """
    if fields is not None and known is not None:
        unknown = sorted(set(fields) - set(known))
        if unknown:
            raise ValueError(
                f"{name} has unknown field(s) {unknown}; valid fields are "
                f"{sorted(known)}"
            )
    normalized: dict[str, frozenset] = {}
    for field, values in (indices or {}).items():
        cast = frozenset(int(v) for v in values)
        bad = sorted(v for v in cast if v < 0)
        if bad:
            raise ValueError(
                f"{name}.{field} schedules 0-based indices; got negative "
                f"index(es) {bad}"
            )
        normalized[field] = cast
    for field, value in (nonneg or {}).items():
        if value < 0:
            raise ValueError(f"{name}.{field} must be >= 0, got {value}")
    for a, b in exclusive:
        overlap = normalized.get(a, frozenset()) & normalized.get(
            b, frozenset()
        )
        if overlap:
            raise ValueError(
                f"conflicting {name} schedules: {a} and {b} both fire at "
                f"index(es) {sorted(overlap)} — one attempt cannot take "
                f"two fates"
            )
    return normalized
