"""Mutation operators (counterpart of ``evox_tpu/operators/mutation``)."""

__all__ = ["polynomial_mutation"]

from .pm_mutation import polynomial_mutation
