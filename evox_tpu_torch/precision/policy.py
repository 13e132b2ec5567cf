"""Mixed-precision storage policy (counterpart of
``evox_tpu/precision/policy.py``).

The policy separates two dtypes:

* **storage** — what a mapped state leaf is carried as between
  generations: the dtype of a fused segment's carried state (a captured
  CUDA graph's static buffers) and of the state on the per-step path.
  ``bfloat16`` halves the bytes of every mapped leaf.
* **compute** — what one generation's math runs in.  The workflow's step
  seam promotes mapped leaves to the compute dtype on entry and demotes
  them on exit, so reductions, best-fold comparisons and the algorithm's
  update arithmetic never accumulate in the narrow type.

Which leaves are mapped is per algorithm and declarative: an algorithm
opts in by declaring ``storage_leaves``, a tuple of state-leaf names (or a
``{name: dtype}`` map) naming the population-sized buffers that are safe
to narrow.  Applying a policy to an algorithm with no declaration raises.

Dtype names map to ``torch`` dtypes by :data:`DTYPES`.  The checkpoint
manifest guard (the JAX package's ``check_precision``) belongs with the
checkpoint layer and is not part of this module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import torch

__all__ = [
    "PrecisionPolicy",
    "precision_identity",
    "precision_tag",
    "check_precision",
    "DEFAULT_PRECISION_TAG",
]

# The tag a policy-less run is described by: full-precision storage,
# identical compute.
DEFAULT_PRECISION_TAG = "storage=float32,compute=float32"

_STORAGE_DTYPES = ("bfloat16", "float16", "float32")
_COMPUTE_DTYPES = ("float32", "float64")

# Dtype names (the JAX package's spelling) as torch dtypes.
DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def _dtype(name: Any) -> torch.dtype:
    """A dtype name (or a torch dtype) as a torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[str(name)]


@dataclass(frozen=True)
class PrecisionPolicy:
    """Declarative mixed-precision policy: ``storage`` dtype for the
    algorithm's mapped state leaves, ``compute`` dtype for the step's math.

    :param storage: dtype name the mapped leaves are carried as between
        generations (``"bfloat16"`` or ``"float16"``; ``"float32"`` makes
        the policy an identity).
    :param compute: dtype name one generation's arithmetic runs in
        (``"float32"`` default, or ``"float64"``).
    :param leaves: optional explicit per-leaf map overriding the
        algorithm's ``storage_leaves`` declaration: a tuple of leaf names
        (all stored as ``storage``) or a ``{name: dtype}`` mapping.
        Normalised to a sorted tuple of ``(name, dtype)`` pairs.
    """

    storage: str = "bfloat16"
    compute: str = "float32"
    leaves: tuple = None  # tuple[tuple[str, str], ...] once normalised

    def __post_init__(self) -> None:
        if self.storage not in _STORAGE_DTYPES:
            raise ValueError(
                f"storage must be one of {_STORAGE_DTYPES}, got "
                f"{self.storage!r}"
            )
        if self.compute not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute must be one of {_COMPUTE_DTYPES}, got "
                f"{self.compute!r}"
            )
        if self.leaves is not None:
            # A canonical, hashable, order-independent form.
            if isinstance(self.leaves, Mapping):
                pairs = tuple(sorted((str(k), str(v)) for k, v in self.leaves.items()))
            else:
                pairs = tuple(
                    sorted(
                        (str(leaf), self.storage)
                        if isinstance(leaf, str)
                        else (str(leaf[0]), str(leaf[1]))
                        for leaf in self.leaves
                    )
                )
            for _, dt in pairs:
                if dt not in _STORAGE_DTYPES:
                    raise ValueError(
                        f"per-leaf storage dtype must be one of "
                        f"{_STORAGE_DTYPES}, got {dt!r}"
                    )
            object.__setattr__(self, "leaves", pairs)

    # -- dtype handles ------------------------------------------------------
    @property
    def storage_dtype(self) -> torch.dtype:
        return DTYPES[self.storage]

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.compute]

    # -- per-algorithm leaf map --------------------------------------------
    def leaf_map(self, algorithm: Any) -> dict[str, torch.dtype]:
        """The ``{leaf_name: storage_dtype}`` map this policy applies to
        ``algorithm``'s state.  Explicit ``leaves`` win; otherwise the
        algorithm's ``storage_leaves`` declaration.  Raises ``TypeError``
        when neither exists."""
        if self.leaves is not None:
            return {name: DTYPES[dt] for name, dt in self.leaves}
        declared = getattr(algorithm, "storage_leaves", None)
        if declared is None:
            raise TypeError(
                f"{type(algorithm).__name__} declares no `storage_leaves` "
                f"map, so a PrecisionPolicy cannot be applied to it: narrow "
                f"storage is opt-in per algorithm (declare the class "
                f"attribute naming the population-sized leaves that are "
                f"safe to store narrow, or pass PrecisionPolicy(leaves=...) "
                f"to override explicitly)"
            )
        if isinstance(declared, Mapping):
            return {str(k): _dtype(v) for k, v in declared.items()}
        return {str(name): self.storage_dtype for name in declared}

    def validate_state(self, algo_state: Any, leaf_map: Mapping[str, Any]) -> None:
        """Refuse a map naming leaves the state does not have: a misnamed
        entry would otherwise run at full precision under a narrow-policy
        identity."""
        missing = sorted(set(leaf_map) - set(algo_state))
        if missing:
            raise ValueError(
                f"PrecisionPolicy maps state leaves {missing} that do not "
                f"exist in the algorithm state (leaves: "
                f"{sorted(algo_state)}): a misnamed entry would silently "
                f"run at full precision under a narrow-policy identity — "
                f"fix the leaves= map or the storage_leaves declaration"
            )

    # -- the cast seam ------------------------------------------------------
    def _cast(self, state: Any, target_of) -> Any:
        """Cast mapped leaves of a flat algorithm ``State`` via
        ``target_of(leaf_name) -> dtype | None`` (None: leave alone).  Keys
        (int64 tensors) and other non-float leaves are never touched."""
        updates = {}
        for name in state:
            dtype = target_of(name)
            if dtype is None:
                continue
            leaf = state[name]
            if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
                continue
            if leaf.dtype != dtype:
                updates[name] = leaf.to(dtype)
        return state.replace(**updates) if updates else state

    def demote(self, algo_state: Any, leaf_map: Mapping[str, Any]) -> Any:
        """Storage form: mapped leaves narrowed to their storage dtype."""
        return self._cast(algo_state, leaf_map.get)

    def promote(self, algo_state: Any, leaf_map: Mapping[str, Any]) -> Any:
        """Compute form: mapped leaves widened to the compute dtype for one
        generation's math."""
        compute = self.compute_dtype
        return self._cast(algo_state, lambda name: compute if name in leaf_map else None)

    # -- identity -----------------------------------------------------------
    def identity(self) -> tuple:
        """Hashable identity of this policy."""
        return ("precision", self.storage, self.compute, self.leaves)

    def tag(self) -> str:
        """Manifest form of the identity."""
        base = f"storage={self.storage},compute={self.compute}"
        if self.leaves is not None:
            base += ",leaves=" + ";".join(f"{n}:{d}" for n, d in self.leaves)
        return base


def precision_identity(policy: PrecisionPolicy | None) -> tuple:
    """The policy's identity, total over ``None`` (full precision)."""
    if policy is None:
        return ("precision", "float32", "float32", None)
    return policy.identity()


def precision_tag(policy: PrecisionPolicy | None) -> str:
    """The policy's manifest tag, total over ``None``."""
    return DEFAULT_PRECISION_TAG if policy is None else policy.tag()


def check_precision(manifest_tag: str | None, policy: PrecisionPolicy | None, *, context: str = "checkpoint") -> None:
    """The manifest guard: refuse to load a checkpoint across a precision
    boundary.  ``manifest_tag`` is the archive's ``precision`` entry
    (``None`` for an archive without one: full precision, what a
    policy-less writer produced); ``policy`` is what the loading run is
    configured with.  Raises
    :class:`~evox_tpu_torch.utils.checkpoint.CheckpointError` on any
    mismatch: a bfloat16 archive would otherwise load cleanly into a
    float32 run under the same-kind dtype cast, and the other way round."""
    from ..utils.checkpoint import CheckpointError

    recorded = manifest_tag if manifest_tag else DEFAULT_PRECISION_TAG
    expected = precision_tag(policy)
    if recorded != expected:
        raise CheckpointError(
            f"{context}: precision policy mismatch — the archive was "
            f"written under [{recorded}] but this run is configured for "
            f"[{expected}]. A checkpoint never crosses a precision "
            f"boundary silently: load it with the matching "
            f"PrecisionPolicy, or re-seed the run."
        )
