"""Dedicated CompactModulus / UintModulus kernels.

Reference: ``crates/primus_modulus/src/common/compact/`` — the branchless
wrapping-select add/sub tier exploiting ``q < 2^(BITS-2)``
(``primitive.rs``), the lazy difference ``a + q - b``, and the slice
multiply/dot tier (``slice.rs``, ``simd/mul.rs``) that accumulates
``DOT_PRODUCT_INNER_CHUNK = 16`` widening products before reducing.

Design, not a port:

- add/sub/double/once are single ``jnp.minimum`` selects on the wrapped
  value (the compact trick vectorizes to one elementwise op where the generic
  compare-subtract needs a compare + select).
- the widening-mul tier needs no Barrett ratio *and* no 64-step bit-serial
  walk (``modops.uint_mul32``, the generic Uint tier): canonical inputs
  bound the product by ``q * 2^30`` (u32) / ``q * 2^62`` (u64), so a
  **value-level shift-fold** of ``q << k`` needs only 31 / 63 conditional
  subtracts for ANY modulus size — the fold count follows from the
  product bound, not from ``log2(q)``.
- ``compact_dot*`` mirrors the chunk-16 wide accumulation: sixteen u32
  products sum exactly in 64 bits (``16 * (2^30-1)^2 < 2^64``), one fold
  pass per chunk.

Inputs to the mul/dot tier must be CANONICAL (``< q``) — that bound is
what pays for the short fold chain.  ``q`` may be any array (broadcasts);
values need not be prime.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..numeric.limb import (
    U64,
    mul_wide_u32,
    u64_add,
    u64_eq,
    u64_ge,
    u64_lt,
    u64_min,
    u64_mul_wide,
    u64_select,
    u64_shl,
    u64_shr,
    u64_sub,
    u64_zeros,
)

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# Branchless add/sub tier (q < 2^30 for u32, q < 2^62 for u64):
# wrapping arithmetic + unsigned min replaces compare-select.
# ---------------------------------------------------------------------------


def compact_reduce_once32(v, q):
    """``min(v, v - q)`` wrapping — [0,2q) -> [0,q) in one select."""
    return jnp.minimum(v, v - q)


def compact_add32(a, b, q):
    """Canonical ``(a + b) mod q`` (compact/primitive.rs ``reduce_add``)."""
    s = a + b
    return jnp.minimum(s, s - q)


def compact_sub32(a, b, q):
    """Canonical ``(a - b) mod q`` via wrapping difference + min."""
    d = a - b
    return jnp.minimum(d, d + q)


def compact_double32(a, q):
    s = a << 1
    return jnp.minimum(s, s - q)


def compact_neg32(a, q):
    return jnp.where(a == 0, jnp.zeros_like(a), q - a)


def compact_lazy_sub32(a, b, q):
    """The lazy difference ``a + (q - b)`` in [0,2q), unreduced
    (compact/primitive.rs ``lazy_reduce_sub``)."""
    return a + (q - b)


def compact_reduce_once64(v: U64, q: U64) -> U64:
    return u64_min(v, u64_sub(v, q))


def compact_add64(a: U64, b: U64, q: U64) -> U64:
    s = u64_add(a, b)
    return u64_min(s, u64_sub(s, q))


def compact_sub64(a: U64, b: U64, q: U64) -> U64:
    d = u64_sub(a, b)
    return u64_min(d, u64_add(d, q))


def compact_double64(a: U64, q: U64) -> U64:
    return compact_add64(a, a, q)


def compact_lazy_sub64(a: U64, b: U64, q: U64) -> U64:
    return u64_add(a, u64_sub(q, b))


# ---------------------------------------------------------------------------
# Widening-mul tier: value-level shift-fold (no ratio, no bit-serial walk).
# ---------------------------------------------------------------------------


def compact_reduce_wide32(lo, hi, q, kmax: int) -> jnp.ndarray:
    """Reduces a 64-bit value ``< q * 2^kmax`` mod ``q < 2^30`` by folding
    ``q << k`` for ``k = kmax..0`` (kmax + 1 conditional subtracts)."""
    v = U64(lo, hi)
    for k in range(kmax, -1, -1):
        t = u64_shl(U64(q, jnp.zeros_like(q)), k) if k else U64(q, jnp.zeros_like(q))
        v = u64_min(v, u64_sub(v, t))
    return v.lo


def compact_mul32(a, b, q):
    """Canonical ``a * b mod q`` for canonical inputs, any ``q < 2^30``.

    31 folds: ``a * b < q^2 <= q * 2^30`` regardless of q's actual width —
    about half the generic bit-serial tier (``modops.uint_mul32``)."""
    lo, hi = mul_wide_u32(a, b)
    return compact_reduce_wide32(lo, hi, q, 30)


def compact_mul_add32(a, b, c, q):
    """``(a * b + c) mod q`` with the addend folded into the wide value
    (one reduction instead of reduce-then-add)."""
    lo, hi = mul_wide_u32(a, b)
    w = u64_add(U64(lo, hi), U64(c, jnp.zeros_like(c)))
    return compact_reduce_wide32(w.lo, w.hi, q, 30)


def compact_dot32(a, b, q, axis: int = -1):
    """``sum(a * b) mod q`` along ``axis`` with chunk-16 exact wide
    accumulation (compact/slice.rs ``reduce_dot_product``,
    DOT_PRODUCT_INNER_CHUNK = 16): sixteen canonical u32 products sum
    exactly in 64 bits; one 35-fold pass reduces each chunk."""
    a = jnp.moveaxis(a, axis, -1)
    b = jnp.moveaxis(b, axis, -1)
    n = a.shape[-1]
    chunk = 16
    pad = (-n) % chunk
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])
        b = jnp.pad(b, [(0, 0)] * (b.ndim - 1) + [(0, pad)])
    a = a.reshape(*a.shape[:-1], -1, chunk)
    b = b.reshape(*b.shape[:-1], -1, chunk)
    lo, hi = mul_wide_u32(a, b)
    acc = u64_zeros(lo.shape[:-1])
    for j in range(chunk):  # exact: 16 * (2^30-1)^2 < 2^64
        acc = u64_add(acc, U64(lo[..., j], hi[..., j]))
    qb = jnp.broadcast_to(jnp.asarray(q, _U32), acc.lo.shape)
    part = compact_reduce_wide32(acc.lo, acc.hi, qb, 34)  # < 16 q^2 <= q 2^34
    out = part[..., 0]
    for j in range(1, part.shape[-1]):
        out = compact_add32(out, part[..., j], qb[..., 0])
    return out


# -- u64 tier: 128-bit fold over (hi, lo) U64 pairs -------------------------


def _u128_ge(ah: U64, al: U64, bh: U64, bl: U64):
    return u64_lt(bh, ah) | (u64_eq(ah, bh) & u64_ge(al, bl))


def _u128_sub(ah: U64, al: U64, bh: U64, bl: U64):
    borrow = u64_lt(al, bl)
    rl = u64_sub(al, bl)
    rh = u64_sub(u64_sub(ah, bh), U64(borrow.astype(_U32), jnp.zeros_like(ah.lo)))
    return rh, rl


def compact_reduce_wide64(lo: U64, hi: U64, q: U64, kmax: int) -> U64:
    """Reduces a 128-bit value ``< q * 2^kmax`` mod ``q < 2^62``."""
    zero = u64_zeros(q.lo.shape)
    vh, vl = hi, lo
    for k in range(kmax, -1, -1):
        if k == 0:
            th, tl = zero, q
        elif k < 64:
            th, tl = u64_shr(q, 64 - k), u64_shl(q, k)
        else:
            th, tl = u64_shl(q, k - 64), zero
        ge = _u128_ge(vh, vl, th, tl)
        sh, sl = _u128_sub(vh, vl, th, tl)
        vh = u64_select(ge, sh, vh)
        vl = u64_select(ge, sl, vl)
    return vl


def compact_mul64(a: U64, b: U64, q: U64) -> U64:
    """Canonical ``a * b mod q`` for canonical inputs, any ``q < 2^62``
    (63 folds: ``a * b < q^2 <= q * 2^62``); about half the generic
    128-step bit-serial tier (``modops.uint_mul64``)."""
    lo, hi = u64_mul_wide(a, b)
    qb = U64(
        jnp.broadcast_to(q.lo, lo.lo.shape), jnp.broadcast_to(q.hi, lo.lo.shape)
    )
    return compact_reduce_wide64(lo, hi, qb, 62)


def compact_dot64(a: U64, b: U64, q: U64, axis: int = -1) -> U64:
    """``sum(a * b) mod q`` with chunk-8 exact 128-bit accumulation
    (eight < 2^124 products sum exactly in 128 bits)."""
    al = jnp.moveaxis(a.lo, axis, -1)
    ah = jnp.moveaxis(a.hi, axis, -1)
    bl = jnp.moveaxis(b.lo, axis, -1)
    bh = jnp.moveaxis(b.hi, axis, -1)
    n = al.shape[-1]
    chunk = 8
    pad = (-n) % chunk
    if pad:
        padw = [(0, 0)] * (al.ndim - 1) + [(0, pad)]
        al, ah, bl, bh = (jnp.pad(x, padw) for x in (al, ah, bl, bh))
    shp = (*al.shape[:-1], -1, chunk)
    av = U64(al.reshape(shp), ah.reshape(shp))
    bv = U64(bl.reshape(shp), bh.reshape(shp))
    plo, phi = u64_mul_wide(av, bv)
    acc_l = u64_zeros(plo.lo.shape[:-1])
    acc_h = u64_zeros(plo.lo.shape[:-1])
    for j in range(chunk):
        pl = U64(plo.lo[..., j], plo.hi[..., j])
        ph = U64(phi.lo[..., j], phi.hi[..., j])
        nl = u64_add(acc_l, pl)
        carry = u64_lt(nl, pl)
        acc_h = u64_add(u64_add(acc_h, ph), U64(carry.astype(_U32), jnp.zeros_like(carry, _U32)))
        acc_l = nl
    qb = U64(
        jnp.broadcast_to(q.lo, acc_l.lo.shape),
        jnp.broadcast_to(q.hi, acc_l.lo.shape),
    )
    part = compact_reduce_wide64(acc_l, acc_h, qb, 65)  # < 8 q^2 <= q 2^65
    out = U64(part.lo[..., 0], part.hi[..., 0])
    q0 = U64(qb.lo[..., 0], qb.hi[..., 0])
    for j in range(1, part.lo.shape[-1]):
        out = compact_add64(out, U64(part.lo[..., j], part.hi[..., j]), q0)
    return out
