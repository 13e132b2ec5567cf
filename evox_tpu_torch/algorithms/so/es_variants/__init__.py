"""Evolution-strategy family (counterpart of
``evox_tpu/algorithms/so/es_variants``)."""

__all__ = [
    "CMAES",
    "OpenES",
    "XNES",
    "SeparableNES",
    "SNES",
    "DES",
    "ARS",
    "ASEBO",
    "GuidedES",
    "PersistentES",
    "NoiseReuseES",
    "ESMC",
    "adam_single_tensor",
    "sort_by_key",
]

from .ars import ARS
from .asebo import ASEBO
from .cma_es import CMAES
from .des import DES
from .esmc import ESMC
from .guided_es import GuidedES
from .nes import XNES, SeparableNES
from .noise_reuse_es import NoiseReuseES
from .open_es import OpenES
from .opt import adam_single_tensor, sort_by_key
from .persistent_es import PersistentES
from .snes import SNES
