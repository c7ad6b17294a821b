"""Single-limb approximate signed decomposition.

Reference: ``crates/primus_decompose/src/primitive/{basis,common}.rs`` —
``ApproxSignedBasis`` derives per-level bit windows, a carry mask, and an
initial value/carry adjustment mode; each level extracts a window, adds the
incoming carry, and branches into a signed digit plus the next carry:

    temp       = ((value >> shr) & (B-1)) + carry
    next_carry = (temp & carry_mask) != 0          # digit >= B/2 (rounding)
    digit      = 0                        if next_carry and temp > B-1
               = temp + (modulus - B)     if next_carry  (i.e. temp - B mod q)
               = temp                     otherwise

The carry chain is sequential in `level` but level is tiny and static, so
the device program unrolls it (SURVEY.md §7 hard part 5) while vectorizing over
every coefficient of every polynomial at once.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..numeric.limb import (
    U64,
    u64_add_u32,
    u64_and,
    u64_full,
    u64_ge,
    u64_select,
    u64_shr,
    u64_add,
)

_U32 = jnp.uint32


def _derive(modulus: int | None, bits: int, log_basis: int, reverse_length):
    """Host derivation of the decomposition parameters (basis.rs:39-178)."""
    assert log_basis > 0
    basis = 1 << log_basis
    basis_minus_one = basis - 1
    limit = 1 << bits

    if modulus is not None:
        modulus = int(modulus)
        if modulus & (modulus - 1) == 0:
            modulus_is_pow2 = True
            value_bits = modulus.bit_length() - 1
        else:
            modulus_is_pow2 = False
            value_bits = modulus.bit_length()
        assert value_bits >= log_basis
        modulus_minus_basis = modulus - basis
    else:
        modulus_is_pow2 = True
        value_bits = bits
        modulus_minus_basis = (limit - basis) % limit

    decompose_length = value_bits // log_basis
    drop_bits = value_bits - decompose_length * log_basis
    if reverse_length is not None:
        assert decompose_length >= reverse_length
        decompose_length = reverse_length
        drop_bits = value_bits - reverse_length * log_basis
    assert decompose_length > 0

    init_carry_mask = (1 << (drop_bits - 1)) if drop_bits > 0 else None

    carry_mask = 2 if log_basis == 1 else (basis | (basis >> 1))

    wrap_threshold = None
    add = 0
    if not modulus_is_pow2:
        if log_basis == 1:
            if drop_bits != 0:
                value = ((1 << (decompose_length + 1)) - 1) << (drop_bits - 1)
                wrap_threshold = value if value < modulus else None
        else:
            value = 0
            for _ in range(decompose_length):
                value = (value << log_basis) | (basis_minus_one >> 1)
            if drop_bits > 0:
                value = ((value << 1) | 1) << (drop_bits - 1)
            else:
                value += 1
            wrap_threshold = value if value < modulus else None
        add = ((1 << value_bits) - 1) - (modulus - 1)

    return dict(
        modulus=modulus,
        modulus_is_pow2=modulus_is_pow2,
        basis=basis,
        basis_minus_one=basis_minus_one,
        modulus_minus_basis=modulus_minus_basis,
        value_bits=value_bits,
        decompose_length=decompose_length,
        log_basis=log_basis,
        drop_bits=drop_bits,
        carry_mask=carry_mask,
        init_carry_mask=init_carry_mask,
        wrap_threshold=wrap_threshold,
        adjust_add=add,
        scalars=[1 << (drop_bits + j * log_basis) for j in range(decompose_length)],
        shr_bits=[drop_bits + j * log_basis for j in range(decompose_length)],
    )


class ApproxSignedBasis32:
    """uint32 approximate signed basis (values mod ``modulus`` or ``2^32``)."""

    def __init__(self, modulus: int | None, log_basis: int, reverse_length: int | None = None):
        p = _derive(modulus, 32, log_basis, reverse_length)
        self.__dict__.update(p)

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    # -- device ops ---------------------------------------------------------

    def init_value_carry(self, values):
        """Adjust values and extract initial carries (basis.rs:254-300).

        Returns ``(adjusted, carries)`` with ``carries`` boolean.
        """
        v = values
        if self.wrap_threshold is not None:
            thr = _U32(self.wrap_threshold)
            v = jnp.where(v >= thr, v + _U32(self.adjust_add), v)
        if self.init_carry_mask is not None:
            carries = (v & _U32(self.init_carry_mask)) != 0
        else:
            carries = jnp.zeros(v.shape, dtype=bool)
        return v, carries

    def decompose_level(self, values, carries, level: int):
        """One signed-digit extraction; returns ``(digit, next_carries)``."""
        shr = self.shr_bits[level]
        temp = ((values >> shr) & _U32(self.basis_minus_one)) + carries.astype(_U32)
        next_carry = (temp & _U32(self.carry_mask)) != 0
        over = temp > _U32(self.basis_minus_one)
        signed = jnp.where(
            over, jnp.zeros_like(temp), temp + _U32(self.modulus_minus_basis)
        )
        digit = jnp.where(next_carry, signed, temp)
        return digit, next_carry

    @functools.partial(jax.jit, static_argnums=0)
    def decompose(self, values):
        """All levels: returns digits stacked on a new leading axis."""
        v, carries = self.init_value_carry(values)
        digits = []
        for lvl in range(self.decompose_length):
            d, carries = self.decompose_level(v, carries, lvl)
            digits.append(d)
        return jnp.stack(digits, axis=0)


class ApproxSignedBasis64:
    """U64 approximate signed basis (values mod ``modulus`` or ``2^64``)."""

    def __init__(self, modulus: int | None, log_basis: int, reverse_length: int | None = None):
        p = _derive(modulus, 64, log_basis, reverse_length)
        self.__dict__.update(p)

    @property
    def approximate_error_bound(self) -> int:
        return 0 if self.drop_bits == 0 else 1 << (self.drop_bits - 1)

    def init_value_carry(self, values: U64):
        v = values
        if self.wrap_threshold is not None:
            thr = u64_full(v.lo.shape, self.wrap_threshold)
            add = u64_full(v.lo.shape, self.adjust_add)
            v = u64_select(u64_ge(v, thr), u64_add(v, add), v)
        if self.init_carry_mask is not None:
            mask = u64_full(v.lo.shape, self.init_carry_mask)
            masked = u64_and(v, mask)
            carries = (masked.lo | masked.hi) != 0
        else:
            carries = jnp.zeros(v.lo.shape, dtype=bool)
        return v, carries

    def decompose_level(self, values: U64, carries, level: int):
        shr = self.shr_bits[level]
        window = u64_shr(values, shr) if shr < 64 else U64(
            jnp.zeros_like(values.lo), jnp.zeros_like(values.hi)
        )
        bmo = u64_full(values.lo.shape, self.basis_minus_one)
        temp = u64_add_u32(u64_and(window, bmo), carries.astype(_U32))
        cmask = u64_full(values.lo.shape, self.carry_mask)
        masked = u64_and(temp, cmask)
        next_carry = (masked.lo | masked.hi) != 0
        over = ~u64_ge(bmo, temp)  # temp > basis-1
        mmb = u64_full(values.lo.shape, self.modulus_minus_basis)
        zero = U64(jnp.zeros_like(temp.lo), jnp.zeros_like(temp.hi))
        signed = u64_select(over, zero, u64_add(temp, mmb))
        digit = u64_select(next_carry, signed, temp)
        return digit, next_carry

    @functools.partial(jax.jit, static_argnums=0)
    def decompose(self, values: U64) -> U64:
        v, carries = self.init_value_carry(values)
        lo, hi = [], []
        for lvl in range(self.decompose_length):
            d, carries = self.decompose_level(v, carries, lvl)
            lo.append(d.lo)
            hi.append(d.hi)
        return U64(jnp.stack(lo, axis=0), jnp.stack(hi, axis=0))
