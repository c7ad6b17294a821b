"""RNS basis with CRT precomputations.

Reference: ``crates/primus_rns/src/base.rs`` — ``RNSBase`` stores the basis
product ``Q`` (limbs), punctured products ``Q/q_i``, and Shoup factors of
``(Q/q_i)^-1 mod q_i``; decompose maps big integers to residues, compose
recombines via ``sum |x * (Q/q_i)^-1|_{q_i} * (Q/q_i) mod Q``
(base.rs:574-718), and ``wrapping_decompose`` lifts small centered values
into every modulus (base.rs:200-311).

Design: residues live modulus-major — a CRT polynomial is a ``(k, N)``
array, the natural shard axis (SURVEY.md §5).  The per-coefficient limb
walks of the reference become batched limb-axis ops from
:mod:`primus_fhe_tpu.numeric.bigint`, vectorized over all ``N`` coefficients
at once.
"""

from __future__ import annotations

import functools

from functools import reduce

import jax
import jax.numpy as jnp
import numpy as np

from ..modular.factor import (
    ShoupFactor32,
    ShoupFactor64,
    factor_mul32,
    factor_mul64,
    shoup32,
    shoup64,
)
from ..modular.modulus import barrett32, barrett64
from ..numeric.bigint import (
    big_cond_sub,
    big_from_int,
    big_mod_u32_dot,
    big_mod_u64_dot,
    big_mul_u32_add,
)
from ..numeric.limb import U64, to_u64_pair, u64_sub, u64_select
from ..utils.gcd import mod_inv, xgcd

_U32 = jnp.uint32


def _check_coprime(moduli):
    if not moduli:
        raise ValueError("empty RNS base")
    for i in range(len(moduli)):
        for j in range(i + 1, len(moduli)):
            if xgcd(moduli[i], moduli[j])[0] != 1:
                raise ValueError(f"moduli {moduli[i]} and {moduli[j]} not coprime")


class _RNSBaseCommon:
    """Shared host precompute for both widths."""

    def __init__(self, moduli: list[int]):
        moduli = [int(q) for q in moduli]
        _check_coprime(moduli)
        self.moduli_ints = moduli
        self.count = len(moduli)
        self.q_product = reduce(lambda a, b: a * b, moduli)
        # limb count of Q in u32 limbs
        self.big_len = max(1, (self.q_product.bit_length() + 31) // 32)
        self.punctured_ints = [self.q_product // q for q in moduli]
        self.inv_punctured_ints = [
            mod_inv(p % q, q) for p, q in zip(self.punctured_ints, moduli)
        ]
        L = self.big_len
        # (k, L+1): punctured products in the extended accumulator width.
        self.punctured_limbs = jnp.asarray(
            np.stack([big_from_int(p, L + 1) for p in self.punctured_ints])
        )
        # (k, L+1): punctured products shifted one limb (for u64 scalars).
        self.punctured_limbs_shift = jnp.asarray(
            np.stack(
                [big_from_int((p << 32) % (1 << (32 * (L + 1))), L + 1) for p in self.punctured_ints]
            )
        )
        self.q_limbs = jnp.asarray(big_from_int(self.q_product, L))
        self.q_limbs_ext = jnp.asarray(big_from_int(self.q_product, L + 1))

    def _pow_table_ints(self):
        """2^(32 i) mod q_k, shape (k, L)."""
        L = self.big_len
        return [
            [pow(2, 32 * i, q) for i in range(L)] for q in self.moduli_ints
        ]


class RNSBase32(_RNSBaseCommon):
    """RNS basis over 32-bit moduli (``q < 2^31``)."""

    def __init__(self, moduli: list[int]):
        super().__init__(moduli)
        if any(q >= 1 << 31 for q in self.moduli_ints):
            raise ValueError("RNSBase32 requires q < 2^31")
        self.modulus = barrett32(np.array(self.moduli_ints, dtype=np.uint64))  # (k,)
        self.inv_punctured = shoup32(
            np.array(self.inv_punctured_ints, dtype=np.uint64),
            np.array(self.moduli_ints, dtype=np.uint64),
        )  # (k,)
        self.pow_table = jnp.asarray(
            np.array(self._pow_table_ints(), dtype=np.uint32)
        )  # (k, L)

    # -- device ops ---------------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0)
    def decompose(self, values):
        """Big integers ``(..., L)`` -> residues ``(k, ...)``."""
        k, L = self.count, self.big_len
        a = values[None]  # (1, ..., L)
        extra = values.ndim - 1  # batch dims
        pow_t = self.pow_table.reshape((k,) + (1,) * extra + (L,))
        m = self._m_broadcast(extra)
        return big_mod_u32_dot(a, pow_t, m)

    def _m_broadcast(self, extra):
        from ..modular.modulus import BarrettModulus32

        shape = (self.count,) + (1,) * extra
        return BarrettModulus32(
            self.modulus.value.reshape(shape),
            self.modulus.ratio_lo.reshape(shape),
            self.modulus.ratio_hi.reshape(shape),
        )

    def wrapping_decompose_small(self, values, small_mod: int):
        """Centered lift of small values ``(...,)`` into ``(k, ...)``.

        Values below ``ceil(small_mod/2)`` stay; others get
        ``q_i - small_mod + value`` (base.rs:279-311).
        """
        small_mod = int(small_mod)
        k = self.count
        q = self.modulus.value.reshape((k,) + (1,) * values.ndim)
        if small_mod == 2:
            return jnp.broadcast_to(values[None], (k,) + values.shape)
        half = np.uint32((small_mod + 1) // 2)
        lifted = q - np.uint32(small_mod) + values[None]
        return jnp.where(values[None] < half, values[None], lifted)

    @functools.partial(jax.jit, static_argnums=0)
    def compose(self, residues):
        """Residues ``(k, ...)`` -> canonical big integers ``(..., L)``."""
        k, L = self.count, self.big_len
        batch = residues.shape[1:]
        value = jnp.zeros(batch + (L + 1,), dtype=_U32)
        for i in range(k):
            f = ShoupFactor32(self.inv_punctured.value[i], self.inv_punctured.quotient[i])
            prod = factor_mul32(residues[i], f, self.modulus.value[i])
            value, _ = big_mul_u32_add(self.punctured_limbs[i], prod, value)
            value = big_cond_sub(value, self.q_limbs_ext)
        return value[..., :L]


class RNSBase64(_RNSBaseCommon):
    """RNS basis over 62-bit moduli (U64 residues)."""

    def __init__(self, moduli: list[int]):
        super().__init__(moduli)
        if any(q >= 1 << 62 for q in self.moduli_ints):
            raise ValueError("RNSBase64 requires q < 2^62")
        qs = np.array(self.moduli_ints, dtype=np.uint64)
        self.modulus = barrett64(qs)  # (k,)
        self.inv_punctured = shoup64(
            np.array(self.inv_punctured_ints, dtype=np.uint64), qs
        )
        pows = self._pow_table_ints()
        self.pow_table = to_u64_pair(np.array(pows, dtype=np.uint64))  # (k, L)

    def _m_broadcast(self, extra):
        from ..modular.modulus import BarrettModulus64

        shape = (self.count,) + (1,) * extra

        def r(u: U64):
            return U64(u.lo.reshape(shape), u.hi.reshape(shape))

        return BarrettModulus64(r(self.modulus.value), r(self.modulus.ratio0), r(self.modulus.ratio1))

    @functools.partial(jax.jit, static_argnums=0)
    def decompose(self, values) -> U64:
        """Big integers ``(..., L)`` -> residues ``U64 (k, ...)``."""
        k, L = self.count, self.big_len
        a = values[None]
        extra = values.ndim - 1
        shape = (k,) + (1,) * extra + (L,)
        pow_t = U64(self.pow_table.lo.reshape(shape), self.pow_table.hi.reshape(shape))
        m = self._m_broadcast(extra)
        return big_mod_u64_dot(a, pow_t, m)

    def wrapping_decompose_small(self, values: U64, small_mod: int) -> U64:
        """Centered lift of small U64 values ``(...,)`` into ``(k, ...)``."""
        small_mod = int(small_mod)
        k = self.count
        nd = values.lo.ndim
        q = U64(
            self.modulus.value.lo.reshape((k,) + (1,) * nd),
            self.modulus.value.hi.reshape((k,) + (1,) * nd),
        )
        vb = U64(
            jnp.broadcast_to(values.lo[None], (k,) + values.lo.shape),
            jnp.broadcast_to(values.hi[None], (k,) + values.hi.shape),
        )
        if small_mod == 2:
            return vb
        half = (small_mod + 1) // 2
        half_u = U64(
            jnp.uint32(half & 0xFFFFFFFF), jnp.uint32((half >> 32) & 0xFFFFFFFF)
        )
        sm = U64(
            jnp.uint32(small_mod & 0xFFFFFFFF), jnp.uint32((small_mod >> 32) & 0xFFFFFFFF)
        )
        from ..numeric.limb import u64_add, u64_lt

        lifted = u64_add(u64_sub(q, sm), vb)
        return u64_select(u64_lt(vb, half_u), vb, lifted)

    @functools.partial(jax.jit, static_argnums=0)
    def compose(self, residues: U64):
        """Residues ``U64 (k, ...)`` -> canonical big integers ``(..., L)``."""
        k, L = self.count, self.big_len
        batch = residues.lo.shape[1:]
        value = jnp.zeros(batch + (L + 1,), dtype=_U32)
        for i in range(k):
            f = ShoupFactor64(
                U64(self.inv_punctured.value.lo[i], self.inv_punctured.value.hi[i]),
                U64(self.inv_punctured.quotient.lo[i], self.inv_punctured.quotient.hi[i]),
            )
            qi = U64(self.modulus.value.lo[i], self.modulus.value.hi[i])
            ri = U64(residues.lo[i], residues.hi[i])
            prod = factor_mul64(ri, f, qi)
            value, _ = big_mul_u32_add(self.punctured_limbs[i], prod.lo, value)
            value, _ = big_mul_u32_add(self.punctured_limbs_shift[i], prod.hi, value)
            value = big_cond_sub(value, self.q_limbs_ext)
        return value[..., :L]
