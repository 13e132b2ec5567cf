"""Crossover operators (counterpart of ``evox_tpu/operators/crossover``;
SBX only so far)."""

__all__ = ["simulated_binary", "simulated_binary_half"]

from .sbx import simulated_binary, simulated_binary_half
