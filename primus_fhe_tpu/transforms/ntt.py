"""Negacyclic NTT forward/inverse — vectorized jnp reference kernels.

The XLA-fused analogue of the reference's scalar hot loop
(``crates/primus_ntt/src/ntt/prime64/scalar/transform.rs:13-140`` forward,
``:150-330`` inverse): radix-2 Harvey butterflies with Shoup lazy multiplies
and the ``[0,4q)`` / ``[0,2q)`` lazy-range discipline.  The per-stage chunk
specialization (t ∈ {8,4,2,1}) of the Rust code is unnecessary here — each
stage is a reshape to ``(..., m, 2, t)`` plus fully vectorized elementwise
ops, which XLA fuses.

Conventions (identical to the reference):
- forward: normal-order input (``[0,4q)`` ok), bit-reversed output;
  ``out_factor=1`` gives canonical ``[0,q)``, ``out_factor=4`` stays lazy.
- inverse: bit-reversed input in ``[0,2q)``, normal-order output;
  ``out_factor=1`` canonical, ``out_factor=2`` lazy.
- monomial: NTT of ``coeff * X^degree`` with traced ``degree`` (the blind-
  rotation fast path, table.rs:565-650).

Everything broadcasts over leading batch axes: shape ``(..., n)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..modular.modops import reduce_once32, reduce_once64, reduce_twice32, reduce_twice64
from ..numeric.limb import (
    U64,
    mulhi_u32,
    u64_add,
    u64_mul_hi,
    u64_mul_lo,
    u64_sub,
)
from .plan import NttPlan32, NttPlan64
from ..utils.contracts import check_range_u32, check_range_u64

_U32 = jnp.uint32


# ---------------------------------------------------------------------------
# uint32 path
# ---------------------------------------------------------------------------


def _shoup_lazy32(y, w, w_precon, q):
    """`y*w mod q` in [0,2q) — mul_mod_lazy32 (scalar/arithmetic.rs:23-28)."""
    q_hat = mulhi_u32(y, w_precon)
    return w * y - q * q_hat


@functools.partial(jax.jit, static_argnames=('out_factor',))
def forward32(plan: NttPlan32, values, out_factor: int = 1):
    """Forward NTT over uint32; input normal order, output bit-reversed."""
    assert out_factor in (1, 4)
    n = plan.n
    q = plan.q
    check_range_u32(values, q, 4, "forward32 input")
    two_q = q + q
    v = values
    batch = v.shape[:-1]
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        w = plan.roots[m : 2 * m].reshape(m, 1)
        wp = plan.roots_precon[m : 2 * m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        x = v[..., 0, :]
        y = v[..., 1, :]
        tx = reduce_once32(x, two_q)
        ty = _shoup_lazy32(y, w, wp, q)
        v = jnp.stack([tx + ty, tx + two_q - ty], axis=-2)
    v = v.reshape(*batch, n)
    if out_factor == 1:
        v = reduce_twice32(v, q)
    return v


@functools.partial(jax.jit, static_argnames=('out_factor',))
def inverse32(plan: NttPlan32, values, out_factor: int = 1):
    """Inverse NTT over uint32; input bit-reversed in [0,2q), normal output."""
    assert out_factor in (1, 2)
    n = plan.n
    q = plan.q
    check_range_u32(values, q, 2, "inverse32 input")
    two_q = q + q
    v = values
    batch = v.shape[:-1]
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        # inv_roots are consumed sequentially: stage s starts after the
        # n/2 + n/4 + ... roots of earlier stages (transform.rs:186).
        start = 1 + n - (n >> s)
        w = plan.inv_roots[start : start + m].reshape(m, 1)
        wp = plan.inv_roots_precon[start : start + m].reshape(m, 1)
        v = v.reshape(*batch, m, 2, t)
        x = v[..., 0, :]
        y = v[..., 1, :]
        tx = reduce_once32(x + y, two_q)
        ty = _shoup_lazy32(x + two_q - y, w, wp, q)
        v = jnp.stack([tx, ty], axis=-2)
    v = v.reshape(*batch, n)
    half = n >> 1
    x = v[..., :half]
    y = v[..., half:]
    tx = reduce_once32(x + y, two_q)
    ty = x + two_q - y
    ox = _shoup_lazy32(tx, plan.inv_n, plan.inv_n_precon, q)
    oy = _shoup_lazy32(ty, plan.inv_n_w, plan.inv_n_w_precon, q)
    out = jnp.concatenate([ox, oy], axis=-1)
    if out_factor == 1:
        out = reduce_once32(out, q)
    return out


def pointwise_mul32(m, a, b):
    """Canonical pointwise product of two NTT polynomials (Barrett modulus)."""
    from ..modular.modops import mul32

    return mul32(a, b, m)


def monomial32(plan: NttPlan32, degree, negate=False):
    """NTT of ``±X^degree`` (bit-reversed output), with traced ``degree``.

    ``out[j] = ±psi^((2*rev(j)+1) * degree mod 2n)`` — table.rs:565-650.
    ``negate`` selects ``-X^degree`` via the index XOR n trick
    (``psi^n = -1``); it may be a traced boolean.  Degrees wrap mod 2n.
    A general coefficient is a follow-up Shoup/Barrett multiply.
    """
    n = plan.n
    mask = 2 * n - 1
    degree = jnp.asarray(degree, dtype=jnp.int32)
    idx = (plan.monomial_base * degree) & mask
    if negate is not False:
        flip = jnp.asarray(negate, dtype=jnp.int32) * n
        idx = idx ^ flip
    return plan.ordinal_roots[idx]


def negacyclic_mul32(plan: NttPlan32, m, a, b):
    """Full negacyclic polynomial product via fwd NTT ×2, pointwise, inv NTT."""
    from ..modular.modops import mul32

    fa = forward32(plan, a)
    fb = forward32(plan, b)
    return inverse32(plan, mul32(fa, fb, m))


# ---------------------------------------------------------------------------
# U64 path
# ---------------------------------------------------------------------------


def _shoup_lazy64(y: U64, w: U64, w_precon: U64, q: U64) -> U64:
    q_hat = u64_mul_hi(y, w_precon)
    return u64_sub(u64_mul_lo(w, y), u64_mul_lo(q, q_hat))


@functools.partial(jax.jit, static_argnames=('out_factor',))
def forward64(plan: NttPlan64, values: U64, out_factor: int = 1) -> U64:
    """Forward NTT over U64 pairs; input normal order, output bit-reversed."""
    assert out_factor in (1, 4)
    check_range_u64(values, plan.q, 4, "forward64 input")
    n = plan.n
    q = plan.q
    two_q = u64_add(q, q)
    v = values
    batch = v.lo.shape[:-1]
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        w = U64(
            plan.roots.lo[m : 2 * m].reshape(m, 1),
            plan.roots.hi[m : 2 * m].reshape(m, 1),
        )
        wp = U64(
            plan.roots_precon.lo[m : 2 * m].reshape(m, 1),
            plan.roots_precon.hi[m : 2 * m].reshape(m, 1),
        )
        v = v.reshape(*batch, m, 2, t)
        x = U64(v.lo[..., 0, :], v.hi[..., 0, :])
        y = U64(v.lo[..., 1, :], v.hi[..., 1, :])
        tx = reduce_once64(x, two_q)
        ty = _shoup_lazy64(y, w, wp, q)
        nx = u64_add(tx, ty)
        ny = u64_sub(u64_add(tx, two_q), ty)
        v = U64(
            jnp.stack([nx.lo, ny.lo], axis=-2),
            jnp.stack([nx.hi, ny.hi], axis=-2),
        )
    v = v.reshape(*batch, n)
    if out_factor == 1:
        v = reduce_twice64(v, q, two_q)
    return v


@functools.partial(jax.jit, static_argnames=('out_factor',))
def inverse64(plan: NttPlan64, values: U64, out_factor: int = 1) -> U64:
    """Inverse NTT over U64 pairs; bit-reversed [0,2q) input, normal output."""
    assert out_factor in (1, 2)
    check_range_u64(values, plan.q, 2, "inverse64 input")
    n = plan.n
    q = plan.q
    two_q = u64_add(q, q)
    v = values
    batch = v.lo.shape[:-1]
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        start = 1 + n - (n >> s)
        w = U64(
            plan.inv_roots.lo[start : start + m].reshape(m, 1),
            plan.inv_roots.hi[start : start + m].reshape(m, 1),
        )
        wp = U64(
            plan.inv_roots_precon.lo[start : start + m].reshape(m, 1),
            plan.inv_roots_precon.hi[start : start + m].reshape(m, 1),
        )
        v = v.reshape(*batch, m, 2, t)
        x = U64(v.lo[..., 0, :], v.hi[..., 0, :])
        y = U64(v.lo[..., 1, :], v.hi[..., 1, :])
        tx = reduce_once64(u64_add(x, y), two_q)
        ty = _shoup_lazy64(u64_sub(u64_add(x, two_q), y), w, wp, q)
        v = U64(
            jnp.stack([tx.lo, ty.lo], axis=-2),
            jnp.stack([tx.hi, ty.hi], axis=-2),
        )
    v = v.reshape(*batch, n)
    half = n >> 1
    x = U64(v.lo[..., :half], v.hi[..., :half])
    y = U64(v.lo[..., half:], v.hi[..., half:])
    tx = reduce_once64(u64_add(x, y), two_q)
    ty = u64_sub(u64_add(x, two_q), y)
    ox = _shoup_lazy64(tx, plan.inv_n, plan.inv_n_precon, q)
    oy = _shoup_lazy64(ty, plan.inv_n_w, plan.inv_n_w_precon, q)
    out = U64(
        jnp.concatenate([ox.lo, oy.lo], axis=-1),
        jnp.concatenate([ox.hi, oy.hi], axis=-1),
    )
    if out_factor == 1:
        out = reduce_once64(out, q)
    return out


def monomial64(plan: NttPlan64, degree, negate=False) -> U64:
    """NTT of ``±X^degree`` over U64 (bit-reversed output), traced ``degree``."""
    n = plan.n
    mask = 2 * n - 1
    degree = jnp.asarray(degree, dtype=jnp.int32)
    idx = (plan.monomial_base * degree) & mask
    if negate is not False:
        flip = jnp.asarray(negate, dtype=jnp.int32) * n
        idx = idx ^ flip
    return U64(plan.ordinal_roots.lo[idx], plan.ordinal_roots.hi[idx])


def pointwise_mul64(m, a: U64, b: U64) -> U64:
    from ..modular.modops import mul64

    return mul64(a, b, m)


def negacyclic_mul64(plan: NttPlan64, m, a: U64, b: U64) -> U64:
    from ..modular.modops import mul64

    fa = forward64(plan, a)
    fb = forward64(plan, b)
    return inverse64(plan, mul64(fa, fb, m))


# ---------------------------------------------------------------------------
# Normal-order convenience variants (reference order-variant parity)
# ---------------------------------------------------------------------------


def _bit_reverse_indices(log_n: int):
    """Static bit-reversal permutation of ``[0, 2^log_n)`` (host numpy)."""
    import numpy as np

    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int32)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bit_reverse_permute(values, log_n: int):
    """Reorders the last axis by bit-reversed index (static gather).

    The device counterpart of the reference's order-conversion step
    between its normal-order and bit-reversed ``NttTable`` entry points
    (``crates/primus_ntt/src/ntt/primitive.rs:27-48``; util
    ``src/reverse.rs:3-32``).  The permutation is its own inverse.
    Convenience path: the hot pipelines keep the bit-reversed contract
    end-to-end and never pay this gather.
    """
    rev = jnp.asarray(_bit_reverse_indices(log_n))
    if isinstance(values, U64):
        return U64(values.lo[..., rev], values.hi[..., rev])
    return values[..., rev]


@functools.partial(jax.jit, static_argnames=("out_factor",))
def forward32_normal_order(plan: NttPlan32, values, out_factor: int = 1):
    """Forward NTT with NORMAL-ORDER output (reference's normal-order
    entry point, ``primitive.rs:27-48``): the fast bit-reversed transform
    followed by the static bit-reversal permutation."""
    return bit_reverse_permute(forward32(plan, values, out_factor), plan.log_n)


@functools.partial(jax.jit, static_argnames=("out_factor",))
def inverse32_normal_order(plan: NttPlan32, values, out_factor: int = 1):
    """Inverse NTT taking NORMAL-ORDER NTT-domain input."""
    return inverse32(plan, bit_reverse_permute(values, plan.log_n), out_factor)


@functools.partial(jax.jit, static_argnames=("out_factor",))
def forward64_normal_order(plan: NttPlan64, values: U64, out_factor: int = 1) -> U64:
    """64-bit forward NTT with NORMAL-ORDER output."""
    return bit_reverse_permute(forward64(plan, values, out_factor), plan.log_n)


@functools.partial(jax.jit, static_argnames=("out_factor",))
def inverse64_normal_order(plan: NttPlan64, values: U64, out_factor: int = 1) -> U64:
    """64-bit inverse NTT taking NORMAL-ORDER NTT-domain input."""
    return inverse64(plan, bit_reverse_permute(values, plan.log_n), out_factor)
