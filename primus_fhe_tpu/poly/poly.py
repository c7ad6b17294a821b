"""Coefficient-domain polynomial operations over Z_q[X]/(X^n + 1).

Reference: ``crates/primus_poly/src/poly/mul.rs:17-148`` (add/sub/neg/
mul_scalar/monomial-mul/evaluate) and the layout conventions of
SURVEY.md §7: a polynomial is just a ``(..., n)`` array (uint32) or U64
pair; an NTT polynomial is the same array in the evaluation domain; a CRT
polynomial carries a leading ``(k,)`` residue axis.  Pointwise NTT-domain
ops live in :mod:`primus_fhe_tpu.modular.modops`; this module holds the
coefficient-domain specials, chiefly the *negacyclic monomial multiply*
used by blind rotation:

    X^d * sum_j a_j X^j  ->  out[k] = ±a[(k - d) mod n],
    negated when ``(k - d) mod 2n >= n``  (X^n = -1).

``d`` is a traced value (data-dependent rotation), so the rotation is a
gather, not a static roll.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..modular import modops
from ..numeric.limb import U64, u64_select

_U32 = jnp.uint32


# -- uint32 path ------------------------------------------------------------


def poly_add32(a, b, q):
    return modops.add32(a, b, q)


def poly_sub32(a, b, q):
    return modops.sub32(a, b, q)


def poly_neg32(a, q):
    return modops.neg32(a, q)


def poly_mul_scalar32(a, scalar, m):
    """Scalar multiply via Barrett (``mul_scalar`` of poly/mul.rs)."""
    return modops.mul32(a, jnp.broadcast_to(jnp.asarray(scalar, _U32), a.shape), m)


def _rot_index(n: int, degree):
    """Gather index and negation mask for a negacyclic shift by ``degree``."""
    degree = jnp.asarray(degree, dtype=jnp.int32)
    k = jnp.arange(n, dtype=jnp.int32)
    kd = (k - degree) % (2 * n)
    return kd % n, kd >= n


def poly_mul_monomial32(a, degree, q):
    """``a * X^degree`` in Z_q[X]/(X^n+1), traced ``degree`` (any sign)."""
    n = a.shape[-1]
    idx, neg = _rot_index(n, degree)
    g = a[..., idx]
    return jnp.where(neg, modops.neg32(g, q), g)


def poly_rotate32(a, degree, q):
    """``a * X^degree`` with traced ``degree`` via bit-chain conditional
    static rolls (one static slice+select per bit of ``degree mod 2n``)
    instead of a data-dependent gather.  ``degree`` broadcasts
    against ``a.shape[:-1]``."""
    n = a.shape[-1]
    d = jnp.asarray(degree, jnp.int32) % (2 * n)
    v = a
    for b in range(n.bit_length()):
        k = 1 << b
        if k == n:
            rolled = modops.neg32(v, q)
        else:
            head = modops.neg32(v[..., n - k :], q)
            rolled = jnp.concatenate([head, v[..., : n - k]], axis=-1)
        take = ((d >> b) & 1)[..., None] == 1
        v = jnp.where(take, rolled, v)
    return v


def poly_rotate64(a: U64, degree, q: U64) -> U64:
    """U64-pair counterpart of :func:`poly_rotate32`."""
    n = a.lo.shape[-1]
    d = jnp.asarray(degree, jnp.int32) % (2 * n)
    v = a
    for b in range(n.bit_length()):
        k = 1 << b
        if k == n:
            rolled = modops.neg64(v, q)
        else:
            head = modops.neg64(U64(v.lo[..., n - k :], v.hi[..., n - k :]), q)
            rolled = U64(
                jnp.concatenate([head.lo, v.lo[..., : n - k]], axis=-1),
                jnp.concatenate([head.hi, v.hi[..., : n - k]], axis=-1),
            )
        take = ((d >> b) & 1)[..., None] == 1
        v = u64_select(take, rolled, v)
    return v


def poly_evaluate32(a, x, m):
    """Horner evaluation at ``x`` (poly/mul.rs:125-148)."""
    acc = jnp.zeros(a.shape[:-1], dtype=_U32)
    for i in range(a.shape[-1] - 1, -1, -1):
        acc = modops.mul_add32(acc, jnp.asarray(x, _U32), a[..., i], m)
    return acc


# -- U64 path ---------------------------------------------------------------


def poly_add64(a: U64, b: U64, q: U64) -> U64:
    return modops.add64(a, b, q)


def poly_sub64(a: U64, b: U64, q: U64) -> U64:
    return modops.sub64(a, b, q)


def poly_neg64(a: U64, q: U64) -> U64:
    return modops.neg64(a, q)


def poly_mul_monomial64(a: U64, degree, q: U64) -> U64:
    """``a * X^degree`` over U64 coefficients, traced ``degree``."""
    n = a.lo.shape[-1]
    idx, neg = _rot_index(n, degree)
    g = U64(a.lo[..., idx], a.hi[..., idx])
    return u64_select(neg, modops.neg64(g, q), g)


def poly_naive_mul32(a, b, m):
    """O(n^2) negacyclic product on device (``naive_mul``, poly/mul.rs).

    The model-based oracle for kernel tests: accumulates ``a_d * (b
    rotated by d)`` with exact modular sums; n iterations of vector work.
    """
    n = a.shape[-1]
    acc = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), dtype=_U32)
    rot = b
    for d in range(n):
        term = modops.mul32(jnp.broadcast_to(a[..., d : d + 1], rot.shape), rot, m)
        acc = modops.add32(acc, term, m.value)
        # multiply rot by X: shift with negacyclic wrap
        head = modops.neg32(rot[..., -1:], m.value)
        rot = jnp.concatenate([head, rot[..., :-1]], axis=-1)
    return acc
