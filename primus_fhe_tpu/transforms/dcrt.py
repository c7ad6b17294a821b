"""DCRT table: independent NTTs over a stacked residue axis.

Reference: ``crates/primus_ntt/src/dcrt/mod.rs:19-135`` — a ``DcrtTable`` is
one NTT table per RNS modulus; ``transform_slice`` runs one NTT per residue
chunk.  Here (SURVEY.md §5) the tables stack along a leading ``(k,)``
axis — root tables become ``(k, n)`` arrays — and one vectorized butterfly
program transforms **all residues of all polynomials at once**, shape
``(k, ..., n)``.  The residue axis is the natural mesh shard axis: each
stage touches only the trailing coefficient axis, so a residue-sharded
DCRT NTT needs zero communication.
"""

from __future__ import annotations

import functools

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..golden.model import GoldenNtt
from ..modular.modops import reduce_once32, reduce_once64, reduce_twice32, reduce_twice64
from ..numeric.limb import U64, mulhi_u32, u64_add, u64_mul_hi, u64_mul_lo, u64_sub
from .plan import build_plan32, build_plan64

_U32 = jnp.uint32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DcrtPlan32:
    """Stacked uint32 NTT plans: all table fields carry a leading (k,) axis."""

    q: jnp.ndarray  # (k, 1)
    roots: jnp.ndarray  # (k, n)
    roots_precon: jnp.ndarray
    inv_roots: jnp.ndarray
    inv_roots_precon: jnp.ndarray
    inv_n: jnp.ndarray  # (k, 1)
    inv_n_precon: jnp.ndarray
    inv_n_w: jnp.ndarray
    inv_n_w_precon: jnp.ndarray
    ordinal_roots: jnp.ndarray  # (k, 2n)
    monomial_base: jnp.ndarray  # (n,)
    log_n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self):
        return 1 << self.log_n

    @property
    def count(self):
        return self.roots.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DcrtPlan64:
    """Stacked U64 NTT plans."""

    q: U64
    roots: U64
    roots_precon: U64
    inv_roots: U64
    inv_roots_precon: U64
    inv_n: U64
    inv_n_precon: U64
    inv_n_w: U64
    inv_n_w_precon: U64
    ordinal_roots: U64
    monomial_base: jnp.ndarray
    log_n: int = dataclasses.field(metadata=dict(static=True))
    moduli: tuple = dataclasses.field(default=(), metadata=dict(static=True))

    @property
    def n(self):
        return 1 << self.log_n

    @property
    def count(self):
        return self.roots.lo.shape[0]


def build_dcrt_plan32(log_n: int, moduli: list[int]) -> DcrtPlan32:
    plans = [build_plan32(log_n, q) for q in moduli]

    def st(field):
        return jnp.stack([getattr(p, field) for p in plans])

    def st1(field):
        return jnp.stack([getattr(p, field) for p in plans]).reshape(len(plans), 1)

    return DcrtPlan32(
        q=st1("q"),
        roots=st("roots"),
        roots_precon=st("roots_precon"),
        inv_roots=st("inv_roots"),
        inv_roots_precon=st("inv_roots_precon"),
        inv_n=st1("inv_n"),
        inv_n_precon=st1("inv_n_precon"),
        inv_n_w=st1("inv_n_w"),
        inv_n_w_precon=st1("inv_n_w_precon"),
        ordinal_roots=st("ordinal_roots"),
        monomial_base=plans[0].monomial_base,
        log_n=log_n,
    )


def build_dcrt_plan64(log_n: int, moduli: list[int]) -> DcrtPlan64:
    plans = [build_plan64(log_n, q) for q in moduli]

    def st(field):
        vals = [getattr(p, field) for p in plans]
        return U64(jnp.stack([v.lo for v in vals]), jnp.stack([v.hi for v in vals]))

    def st1(field):
        v = st(field)
        k = len(plans)
        return U64(v.lo.reshape(k, 1), v.hi.reshape(k, 1))

    return DcrtPlan64(
        q=st1("q"),
        roots=st("roots"),
        roots_precon=st("roots_precon"),
        inv_roots=st("inv_roots"),
        inv_roots_precon=st("inv_roots_precon"),
        inv_n=st1("inv_n"),
        inv_n_precon=st1("inv_n_precon"),
        inv_n_w=st1("inv_n_w"),
        inv_n_w_precon=st1("inv_n_w_precon"),
        ordinal_roots=st("ordinal_roots"),
        monomial_base=plans[0].monomial_base,
        log_n=log_n,
        moduli=tuple(int(q) for q in moduli),
    )


# ---------------------------------------------------------------------------
# Transforms: values (k, ..., n); per-modulus tables broadcast from axis 0.
# ---------------------------------------------------------------------------


def _shoup_lazy32(y, w, wp, q):
    return w * y - q * mulhi_u32(y, wp)


@functools.partial(jax.jit, static_argnames=('out_factor',))
def dcrt_forward32(plan: DcrtPlan32, values, out_factor: int = 1):
    """Forward NTT over all residues: ``(k, ..., n)`` -> ``(k, ..., n)``."""
    assert out_factor in (1, 4)
    n = plan.n
    k = plan.count
    v = values
    mid = v.shape[1:-1]
    q = plan.q.reshape((k,) + (1,) * len(mid) + (1, 1))
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        shape = (k,) + (1,) * len(mid) + (m, 1)
        w = plan.roots[:, m : 2 * m].reshape(shape)
        wp = plan.roots_precon[:, m : 2 * m].reshape(shape)
        v = v.reshape((k,) + mid + (m, 2, t))
        x = v[..., 0, :]
        y = v[..., 1, :]
        two_q = q + q
        tx = reduce_once32(x, two_q)
        ty = _shoup_lazy32(y, w, wp, q)
        v = jnp.stack([tx + ty, tx + two_q - ty], axis=-2)
    v = v.reshape((k,) + mid + (n,))
    if out_factor == 1:
        qq = plan.q.reshape((k,) + (1,) * len(mid) + (1,))
        v = reduce_twice32(v, qq)
    return v


@functools.partial(jax.jit, static_argnames=('out_factor',))
def dcrt_inverse32(plan: DcrtPlan32, values, out_factor: int = 1):
    """Inverse NTT over all residues."""
    assert out_factor in (1, 2)
    n = plan.n
    k = plan.count
    v = values
    mid = v.shape[1:-1]
    q = plan.q.reshape((k,) + (1,) * len(mid) + (1, 1))
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        start = 1 + n - (n >> s)
        shape = (k,) + (1,) * len(mid) + (m, 1)
        w = plan.inv_roots[:, start : start + m].reshape(shape)
        wp = plan.inv_roots_precon[:, start : start + m].reshape(shape)
        v = v.reshape((k,) + mid + (m, 2, t))
        x = v[..., 0, :]
        y = v[..., 1, :]
        two_q = q + q
        tx = reduce_once32(x + y, two_q)
        ty = _shoup_lazy32(x + two_q - y, w, wp, q)
        v = jnp.stack([tx, ty], axis=-2)
    v = v.reshape((k,) + mid + (n,))
    half = n >> 1
    qv = plan.q.reshape((k,) + (1,) * len(mid) + (1,))
    two_q = qv + qv
    bshape = (k,) + (1,) * len(mid) + (1,)
    x = v[..., :half]
    y = v[..., half:]
    tx = reduce_once32(x + y, two_q)
    ty = x + two_q - y
    ox = _shoup_lazy32(tx, plan.inv_n.reshape(bshape), plan.inv_n_precon.reshape(bshape), qv)
    oy = _shoup_lazy32(ty, plan.inv_n_w.reshape(bshape), plan.inv_n_w_precon.reshape(bshape), qv)
    out = jnp.concatenate([ox, oy], axis=-1)
    if out_factor == 1:
        out = reduce_once32(out, qv)
    return out


def _u64_bc(u: U64, shape) -> U64:
    return U64(u.lo.reshape(shape), u.hi.reshape(shape))


def _shoup_lazy64(y: U64, w: U64, wp: U64, q: U64) -> U64:
    return u64_sub(u64_mul_lo(w, y), u64_mul_lo(q, u64_mul_hi(y, wp)))


@functools.partial(jax.jit, static_argnames=('out_factor',))
def dcrt_forward64(plan: DcrtPlan64, values: U64, out_factor: int = 1) -> U64:
    """Forward NTT over all residues: U64 ``(k, ..., n)``."""
    assert out_factor in (1, 4)
    n = plan.n
    k = plan.count
    v = values
    mid = v.lo.shape[1:-1]
    qs = (k,) + (1,) * len(mid) + (1, 1)
    q = _u64_bc(plan.q, qs)
    two_q = u64_add(q, q)
    for s in range(plan.log_n):
        m = 1 << s
        t = n >> (s + 1)
        shape = (k,) + (1,) * len(mid) + (m, 1)
        w = U64(
            plan.roots.lo[:, m : 2 * m].reshape(shape),
            plan.roots.hi[:, m : 2 * m].reshape(shape),
        )
        wp = U64(
            plan.roots_precon.lo[:, m : 2 * m].reshape(shape),
            plan.roots_precon.hi[:, m : 2 * m].reshape(shape),
        )
        v = v.reshape((k,) + mid + (m, 2, t))
        x = U64(v.lo[..., 0, :], v.hi[..., 0, :])
        y = U64(v.lo[..., 1, :], v.hi[..., 1, :])
        tx = reduce_once64(x, two_q)
        ty = _shoup_lazy64(y, w, wp, q)
        nx = u64_add(tx, ty)
        ny = u64_sub(u64_add(tx, two_q), ty)
        v = U64(
            jnp.stack([nx.lo, ny.lo], axis=-2), jnp.stack([nx.hi, ny.hi], axis=-2)
        )
    v = v.reshape((k,) + mid + (n,))
    if out_factor == 1:
        qv = _u64_bc(plan.q, (k,) + (1,) * len(mid) + (1,))
        v = reduce_twice64(v, qv, u64_add(qv, qv))
    return v


@functools.partial(jax.jit, static_argnames=('out_factor',))
def dcrt_inverse64(plan: DcrtPlan64, values: U64, out_factor: int = 1) -> U64:
    """Inverse NTT over all residues: U64 ``(k, ..., n)``."""
    assert out_factor in (1, 2)
    n = plan.n
    k = plan.count
    v = values
    mid = v.lo.shape[1:-1]
    q = _u64_bc(plan.q, (k,) + (1,) * len(mid) + (1, 1))
    two_q = u64_add(q, q)
    for s in range(plan.log_n - 1):
        t = 1 << s
        m = n >> (s + 1)
        start = 1 + n - (n >> s)
        shape = (k,) + (1,) * len(mid) + (m, 1)
        w = U64(
            plan.inv_roots.lo[:, start : start + m].reshape(shape),
            plan.inv_roots.hi[:, start : start + m].reshape(shape),
        )
        wp = U64(
            plan.inv_roots_precon.lo[:, start : start + m].reshape(shape),
            plan.inv_roots_precon.hi[:, start : start + m].reshape(shape),
        )
        v = v.reshape((k,) + mid + (m, 2, t))
        x = U64(v.lo[..., 0, :], v.hi[..., 0, :])
        y = U64(v.lo[..., 1, :], v.hi[..., 1, :])
        tx = reduce_once64(u64_add(x, y), two_q)
        ty = _shoup_lazy64(u64_sub(u64_add(x, two_q), y), w, wp, q)
        v = U64(jnp.stack([tx.lo, ty.lo], axis=-2), jnp.stack([tx.hi, ty.hi], axis=-2))
    v = v.reshape((k,) + mid + (n,))
    half = n >> 1
    bshape = (k,) + (1,) * len(mid) + (1,)
    qv = _u64_bc(plan.q, bshape)
    two_qv = u64_add(qv, qv)
    x = U64(v.lo[..., :half], v.hi[..., :half])
    y = U64(v.lo[..., half:], v.hi[..., half:])
    tx = reduce_once64(u64_add(x, y), two_qv)
    ty = u64_sub(u64_add(x, two_qv), y)
    ox = _shoup_lazy64(tx, _u64_bc(plan.inv_n, bshape), _u64_bc(plan.inv_n_precon, bshape), qv)
    oy = _shoup_lazy64(
        ty, _u64_bc(plan.inv_n_w, bshape), _u64_bc(plan.inv_n_w_precon, bshape), qv
    )
    out = U64(
        jnp.concatenate([ox.lo, oy.lo], axis=-1),
        jnp.concatenate([ox.hi, oy.hi], axis=-1),
    )
    if out_factor == 1:
        out = reduce_once64(out, qv)
    return out


def dcrt_monomial64(plan: DcrtPlan64, degree, negate=False) -> U64:
    """NTT of ``±X^degree`` for every modulus: ``U64 (k, n)``.

    The DCRT analogue of ``transform_monomial`` (table.rs:565-650) — in the
    NTT domain a monomial is diagonal, so DCRT-domain rotation is one
    pointwise multiply per modulus.
    """
    n = plan.n
    mask = 2 * n - 1
    degree = jnp.asarray(degree, dtype=jnp.int32)
    idx = (plan.monomial_base * degree) & mask
    if negate is not False:
        flip = jnp.asarray(negate, dtype=jnp.int32) * n
        idx = idx ^ flip
    return U64(plan.ordinal_roots.lo[:, idx], plan.ordinal_roots.hi[:, idx])
