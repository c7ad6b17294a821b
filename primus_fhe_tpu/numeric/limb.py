"""u32-limb integer kernels — the device-side ``widening_mul`` layer.

JAX integer code here stays in 32-bit lanes (no ``jax_enable_x64``), so
every 62-bit modular operation is built from exact u32 primitives, exactly
as the reference builds 64-bit Barrett on 128-bit intermediates (``crates/primus_integer/src/integer_traits/
widening/``).  The invariant is *deterministic integer semantics*: every
function here computes the mathematically exact result with uint32 wrapping
arithmetic only — valid in jnp-traced code and NumPy alike.

A 64-bit value is a ``U64(lo, hi)`` pair of uint32 arrays (structure-of-
arrays: friendliest layout for vector lanes and for sharding).  Host-side
``numpy.uint64`` arrays convert via :func:`to_u64_pair` /
:func:`from_u64_pair`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

_U16 = 0xFFFF
_U32 = jnp.uint32


class U64(NamedTuple):
    """A 64-bit unsigned integer as two uint32 arrays ``hi * 2^32 + lo``."""

    lo: jnp.ndarray
    hi: jnp.ndarray

    @property
    def shape(self):
        return jnp.shape(self.lo)

    def __getitem__(self, idx):  # NamedTuple indexing would return fields
        if isinstance(idx, int) and idx in (0, 1):
            return tuple.__getitem__(self, idx)
        return U64(self.lo[idx], self.hi[idx])

    def reshape(self, *shape):
        return U64(self.lo.reshape(*shape), self.hi.reshape(*shape))


# ---------------------------------------------------------------------------
# Host conversions
# ---------------------------------------------------------------------------


def to_u64_pair(x) -> U64:
    """Converts a host uint64 array (or python ints) into a ``U64`` pair."""
    arr = np.asarray(x, dtype=np.uint64)
    lo = (arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (arr >> np.uint64(32)).astype(np.uint32)
    return U64(jnp.asarray(lo), jnp.asarray(hi))


def from_u64_pair(v: U64) -> np.ndarray:
    """Converts a ``U64`` pair back into a host uint64 array."""
    lo = np.asarray(v.lo, dtype=np.uint64)
    hi = np.asarray(v.hi, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def u64_from_u32(x) -> U64:
    x = jnp.asarray(x, dtype=_U32)
    return U64(x, jnp.zeros_like(x))


def u64_zeros(shape) -> U64:
    z = jnp.zeros(shape, dtype=_U32)
    return U64(z, z)


def u64_full(shape, value: int) -> U64:
    value = int(value)
    return U64(
        jnp.full(shape, value & 0xFFFFFFFF, dtype=_U32),
        jnp.full(shape, (value >> 32) & 0xFFFFFFFF, dtype=_U32),
    )


# ---------------------------------------------------------------------------
# 32-bit widening primitives
# ---------------------------------------------------------------------------


def mul_wide_u32(a, b) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Exact ``a * b`` for uint32 inputs, returned as ``(lo, hi)`` uint32.

    16-bit limb products: each partial fits exactly in uint32, mirroring the
    reference's ``widening_mul`` built on the next-wider type.
    """
    a = jnp.asarray(a, dtype=_U32)
    b = jnp.asarray(b, dtype=_U32)
    a0 = a & _U16
    a1 = a >> 16
    b0 = b & _U16
    b1 = b >> 16
    ll = a0 * b0
    # m1 <= (2^16-1)^2 + (2^16-1) < 2^32: exact.
    m1 = a1 * b0 + (ll >> 16)
    # m2 <= (2^16-1)^2 + (2^16-1) < 2^32: exact.
    m2 = a0 * b1 + (m1 & _U16)
    hi = a1 * b1 + (m1 >> 16) + (m2 >> 16)
    lo = a * b  # native wrapping low half
    return lo, hi


def mulhi_u32(a, b) -> jnp.ndarray:
    """High 32 bits of the exact 64-bit product of two uint32 values."""
    return mul_wide_u32(a, b)[1]


def _carry_of(total, a):
    """Carry bit of a wrapping uint32 add ``total = a + b``."""
    return (total < a).astype(_U32)


# ---------------------------------------------------------------------------
# 64-bit (pair) arithmetic
# ---------------------------------------------------------------------------


def u64_add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    hi = a.hi + b.hi + _carry_of(lo, a.lo)
    return U64(lo, hi)


def u64_add_u32(a: U64, b) -> U64:
    b = jnp.asarray(b, dtype=_U32)
    lo = a.lo + b
    hi = a.hi + _carry_of(lo, a.lo)
    return U64(lo, hi)


def u64_sub(a: U64, b: U64) -> U64:
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(_U32)
    hi = a.hi - b.hi - borrow
    return U64(lo, hi)


def u64_neg(a: U64) -> U64:
    """Two's-complement negation (wrapping ``0 - a``)."""
    lo = jnp.zeros_like(a.lo) - a.lo
    borrow = (a.lo != 0).astype(_U32)
    hi = jnp.zeros_like(a.hi) - a.hi - borrow
    return U64(lo, hi)


def u64_mul_lo(a: U64, b: U64) -> U64:
    """Low 64 bits of the product (wrapping 64-bit multiply)."""
    lo, hi = mul_wide_u32(a.lo, b.lo)
    hi = hi + a.lo * b.hi + a.hi * b.lo
    return U64(lo, hi)


def u64_mul_wide(a: U64, b: U64) -> tuple[U64, U64]:
    """Exact 128-bit product as ``(low64, high64)``.

    Schoolbook on 32-bit limbs with explicit carry propagation — the limb
    dance that replaces the reference's ``u128`` intermediates.
    """
    l00, h00 = mul_wide_u32(a.lo, b.lo)
    l01, h01 = mul_wide_u32(a.lo, b.hi)
    l10, h10 = mul_wide_u32(a.hi, b.lo)
    l11, h11 = mul_wide_u32(a.hi, b.hi)

    r0 = l00
    s1 = h00 + l01
    c1 = _carry_of(s1, h00)
    r1 = s1 + l10
    c1 = c1 + _carry_of(r1, s1)

    s2 = h01 + h10
    c2 = _carry_of(s2, h01)
    s2b = s2 + l11
    c2 = c2 + _carry_of(s2b, s2)
    r2 = s2b + c1
    c2 = c2 + _carry_of(r2, s2b)

    r3 = h11 + c2
    return U64(r0, r1), U64(r2, r3)


def u64_mul_hi(a: U64, b: U64) -> U64:
    """High 64 bits of the exact 128-bit product."""
    return u64_mul_wide(a, b)[1]


# ---------------------------------------------------------------------------
# Comparisons / selection
# ---------------------------------------------------------------------------


def u64_lt(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def u64_ge(a: U64, b: U64) -> jnp.ndarray:
    return ~u64_lt(a, b)


def u64_eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def u64_select(pred, a: U64, b: U64) -> U64:
    """Elementwise ``pred ? a : b``."""
    return U64(jnp.where(pred, a.lo, b.lo), jnp.where(pred, a.hi, b.hi))


def u64_min(a: U64, b: U64) -> U64:
    return u64_select(u64_lt(a, b), a, b)


# ---------------------------------------------------------------------------
# Shifts / bitwise (static shift amounts)
# ---------------------------------------------------------------------------


def u64_shr(a: U64, k: int) -> U64:
    """Logical right shift by a static ``k`` in [0, 64)."""
    k = int(k)
    if k == 0:
        return a
    if k < 32:
        lo = (a.lo >> k) | (a.hi << (32 - k))
        hi = a.hi >> k
        return U64(lo, hi)
    return U64(a.hi >> (k - 32), jnp.zeros_like(a.hi))


def u64_shl(a: U64, k: int) -> U64:
    """Left shift (wrapping) by a static ``k`` in [0, 64)."""
    k = int(k)
    if k == 0:
        return a
    if k < 32:
        hi = (a.hi << k) | (a.lo >> (32 - k))
        lo = a.lo << k
        return U64(lo, hi)
    return U64(jnp.zeros_like(a.lo), a.lo << (k - 32))


def u64_and(a: U64, b: U64) -> U64:
    return U64(a.lo & b.lo, a.hi & b.hi)


def u64_or(a: U64, b: U64) -> U64:
    return U64(a.lo | b.lo, a.hi | b.hi)
