"""Device-side little-endian multi-limb big integers.

The device analogue of the reference's ``BigUint<S>`` limb views
(``crates/primus_integer/src/big_integer.rs``): a big integer is a
``(..., L)`` uint32 array, little-endian limbs along the trailing axis, with
``L`` static.  Batches of coefficients are just leading axes, so the fixed-
width modular add/sub/compare and scalar mul-accumulate used by RNS
compose/decompose vectorize across a whole polynomial at once.

Carry chains run as unrolled Python loops over the (small, static) limb
count — the XLA-friendly analogue of the reference's ``carrying_add`` /
``borrowing_sub`` limb walks.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32


def big_from_int(value: int, limbs: int) -> np.ndarray:
    """Host: encodes a Python int as a little-endian uint32 limb vector."""
    if value < 0:
        raise ValueError("big_from_int expects non-negative values")
    out = np.zeros(limbs, dtype=np.uint32)
    for i in range(limbs):
        out[i] = (value >> (32 * i)) & 0xFFFFFFFF
    if value >> (32 * limbs):
        raise ValueError(f"value does not fit in {limbs} limbs")
    return out


def big_to_int(limbs_arr) -> int:
    """Host: decodes a little-endian uint32 limb vector to a Python int."""
    arr = np.asarray(limbs_arr, dtype=np.uint32)
    return sum(int(v) << (32 * i) for i, v in enumerate(arr))


def big_to_ints(arr) -> np.ndarray:
    """Host: decodes a batch ``(..., L)`` into an object array of ints."""
    a = np.asarray(arr, dtype=np.uint32)
    out = np.zeros(a.shape[:-1], dtype=object)
    for i in range(a.shape[-1]):
        out = out + (a[..., i].astype(object) << (32 * i))
    return out


# ---------------------------------------------------------------------------
# Elementwise batched ops (device) — trailing axis is the limb axis
# ---------------------------------------------------------------------------


def big_add(a, b):
    """``(a + b) mod 2^(32L)`` with full carry propagation."""
    L = a.shape[-1]
    outs = []
    carry = jnp.zeros(a.shape[:-1], dtype=_U32)
    for i in range(L):
        s = a[..., i] + b[..., i]
        c1 = (s < a[..., i]).astype(_U32)
        s2 = s + carry
        c2 = (s2 < s).astype(_U32)
        outs.append(s2)
        carry = c1 + c2
    return jnp.stack(outs, axis=-1), carry


def big_sub(a, b):
    """``(a - b) mod 2^(32L)``; second output is the final borrow (0/1)."""
    L = a.shape[-1]
    outs = []
    borrow = jnp.zeros(a.shape[:-1], dtype=_U32)
    for i in range(L):
        d = a[..., i] - b[..., i]
        b1 = (a[..., i] < b[..., i]).astype(_U32)
        d2 = d - borrow
        b2 = (d < borrow).astype(_U32)
        outs.append(d2)
        borrow = b1 + b2
    return jnp.stack(outs, axis=-1), borrow


def big_ge(a, b):
    """``a >= b`` lexicographically from the most-significant limb."""
    L = a.shape[-1]
    result = jnp.ones(jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=bool)
    decided = jnp.zeros_like(result)
    for i in reversed(range(L)):
        gt = a[..., i] > b[..., i]
        lt = a[..., i] < b[..., i]
        result = jnp.where(~decided & gt, True, jnp.where(~decided & lt, False, result))
        decided = decided | gt | lt
    return result


def big_cond_sub(a, b):
    """``a - b`` where ``a >= b`` else ``a`` (modular wrap-down helper)."""
    diff, _ = big_sub(a, b)
    take = big_ge(a, b)
    return jnp.where(take[..., None], diff, a)


def big_mul_u32_add(a, scalar, acc):
    """``acc + a * scalar`` for a u32 ``scalar``; returns ``(limbs, carry)``.

    The reference's ``mul_value_add_to`` specialized to one 32-bit scalar
    limb; carries propagate exactly through the unrolled limb walk.
    """
    from .limb import mul_wide_u32

    L = a.shape[-1]
    outs = []
    carry = jnp.zeros(a.shape[:-1], dtype=_U32)  # < 2^32 always
    for i in range(L):
        lo, hi = mul_wide_u32(a[..., i], scalar)
        s = lo + acc[..., i]
        c1 = (s < lo).astype(_U32)
        s2 = s + carry
        c2 = (s2 < s).astype(_U32)
        outs.append(s2)
        # hi < 2^32 - 1 and c1 + c2 <= 2, never overflows.
        carry = hi + c1 + c2
    return jnp.stack(outs, axis=-1), carry


def big_mod_u32_dot(a, pow_table, m):
    """``a mod q`` for a 32-bit Barrett modulus via a power-table dot.

    ``pow_table[i] = 2^(32 i) mod q`` (host precomputed).  Each limb maps to
    ``limb * pow mod q`` lazily, the ≤``L`` terms sum exactly in u32×2, one
    wide Barrett reduce finishes.  ``m`` broadcasts against the *output*
    shape (i.e. the input shape minus the limb axis).
    """
    import jax

    from ..modular.modops import barrett_lazy_reduce_wide32, reduce_once32
    from ..modular.modops import lazy_mul32

    m_l = jax.tree.map(lambda x: x[..., None] if jnp.ndim(x) else x, m)
    t = lazy_mul32(a, pow_table, m_l)  # (..., L) lazy products
    s_lo16 = jnp.sum(t & 0xFFFF, axis=-1, dtype=jnp.uint32)
    s_hi16 = jnp.sum(t >> 16, axis=-1, dtype=jnp.uint32)
    lo = s_lo16 + (s_hi16 << 16)
    carry = (lo < s_lo16).astype(_U32)
    hi = (s_hi16 >> 16) + carry
    return reduce_once32(barrett_lazy_reduce_wide32(lo, hi, m), m.value)


def big_mod_u64_dot(a, pow_table, m):
    """``a mod q`` for a 62-bit Barrett modulus via a power-table dot.

    ``pow_table`` is a U64 with trailing axis L: ``2^(32 i) mod q``.  Limbs
    widen to U64, multiply lazily, accumulate exactly, wide-reduce once.
    ``m`` broadcasts against the output shape (input minus the limb axis).
    """
    import jax

    from ..modular.modops import barrett_lazy_reduce_wide64, reduce_once64, lazy_mul64
    from .limb import U64

    m_l = jax.tree.map(lambda x: x[..., None] if jnp.ndim(x) else x, m)
    limbs = U64(a, jnp.zeros_like(a))
    t = lazy_mul64(limbs, pow_table, m_l)  # (..., L) lazy products < 2^63
    # Exact sum of up to 2^16 terms via 16-bit half sums per 32-bit limb.
    def _split_sum(x):
        lo16 = jnp.sum(x & 0xFFFF, axis=-1, dtype=jnp.uint32)
        hi16 = jnp.sum(x >> 16, axis=-1, dtype=jnp.uint32)
        lo = lo16 + (hi16 << 16)
        carry = (lo < lo16).astype(_U32) + (hi16 >> 16)
        return lo, carry

    s0, c0 = _split_sum(t.lo)
    s1, c1 = _split_sum(t.hi)
    w1 = s1 + c0
    carry1 = (w1 < s1).astype(_U32)
    lo = U64(s0, w1)
    hi = U64(c1 + carry1, jnp.zeros_like(s0))
    return reduce_once64(barrett_lazy_reduce_wide64(lo, hi, m), m.value)


def big_shr_window(a, shift_bits: int, width_bits: int):
    """Extracts the ``width_bits``-wide window starting at ``shift_bits``.

    Static offsets; reads at most two adjacent limbs — the multi-limb
    ``ValueMask`` of the reference's BigUint decomposition
    (``crates/primus_decompose/src/big_integer/common.rs:57-130``).
    """
    if width_bits > 32:
        raise ValueError("window wider than one limb is not supported")
    L = a.shape[-1]
    index = shift_bits // 32
    shr = shift_bits % 32
    mask = np.uint32((1 << width_bits) - 1) if width_bits < 32 else np.uint32(0xFFFFFFFF)
    low = a[..., index] >> shr if index < L else jnp.zeros(a.shape[:-1], dtype=_U32)
    if shr + width_bits > 32 and index + 1 < L:
        low = low | (a[..., index + 1] << (32 - shr))
    return low & mask
