"""Pure-Python golden models: the differential-testing oracles.

Translation of the reference's test strategy (SURVEY.md section 4): the
generic ``UintNttTable`` is the oracle for the optimized tables; here a
pure-Python arbitrary-precision model is the oracle for the JAX
kernels.  Everything in this package is exact integer math, deliberately
slow, and never imported by the device path.
"""

from .model import (
    GoldenNtt,
    barrett_lazy_reduce,
    barrett_lazy_reduce_wide,
    barrett_ratio,
    minimal_primitive_root,
    naive_negacyclic_mul,
    shoup_mul_lazy,
    shoup_quotient,
)

__all__ = [
    "GoldenNtt",
    "barrett_lazy_reduce",
    "barrett_lazy_reduce_wide",
    "barrett_ratio",
    "minimal_primitive_root",
    "naive_negacyclic_mul",
    "shoup_mul_lazy",
    "shoup_quotient",
]
