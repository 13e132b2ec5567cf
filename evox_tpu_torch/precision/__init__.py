"""The numerics plane of the port (counterpart of ``evox_tpu/precision``):
mixed-precision storage policies and named key streams.

* :class:`PrecisionPolicy` — bf16/fp16 storage of the algorithm's declared
  ``storage_leaves`` with f32 compute.  The one promote/demote seam is in
  ``StdWorkflow._step``: a fused segment's carried state and the state
  between eager steps hold the storage form, every generation's math the
  compute form.
* :func:`make_key` / :func:`resolve_key_impl` / :func:`coerce_key` — the
  ``key_impl`` knob.  In the port a name selects a stream family of the one
  Philox generator (:mod:`~evox_tpu_torch.precision.prng`), so every name
  draws at the same speed; the same seed draws different streams under
  different names.
* :func:`check_precision` — the checkpoint-manifest guard
  ``utils.load_state(precision=)`` calls: an archive never loads across a
  precision boundary.
"""

from .policy import (
    DEFAULT_PRECISION_TAG,
    PrecisionPolicy,
    check_precision,
    precision_identity,
    precision_tag,
)
from .prng import (
    KEY_IMPLS,
    coerce_key,
    key_impl_name,
    make_key,
    resolve_key_impl,
    state_key_impl,
)

__all__ = [
    "PrecisionPolicy",
    "precision_identity",
    "precision_tag",
    "check_precision",
    "DEFAULT_PRECISION_TAG",
    "KEY_IMPLS",
    "make_key",
    "coerce_key",
    "key_impl_name",
    "state_key_impl",
    "resolve_key_impl",
]
