"""Problem library (counterpart of ``evox_tpu/problems``: numerical and
neuroevolution so far)."""

__all__ = ["neuroevolution", "numerical"]

from . import neuroevolution, numerical
