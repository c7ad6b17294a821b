"""Coefficient-sharded NTT: butterfly exchange over the device mesh.

SURVEY.md §5 scaling axis (b): for polynomials too large for one chip (or
to pipeline many chips over one transform), the coefficient axis shards
over D devices.  Stages whose butterfly stride ``t`` is at least the shard
size pair elements on *different* devices — but because ``t`` is then a
multiple of the shard size, each pair sits at the *same local offset* on
two devices, so the exchange is a pure ``ppermute`` by ``t / shard``
device steps — no data reshuffling within shards.  All remaining
stages are shard-local.

Forward: the ``log2 D`` exchange stages come FIRST (t = n/2 .. shard),
then the shard-local tail — a full width-``shard`` forward transform
over this shard's slice of the expanded per-lane root tables, staged as
roll+mask butterflies.  Inverse mirrors it: the shard-local stages
(t = 1 .. shard/2) run FIRST, then ``log2 D`` ppermute exchange stages,
the last fusing ``inv_n`` / ``inv_n·w`` per the single-device convention
(crates/primus_ntt/src/ntt/prime64/table.rs:54-58) so outputs are
bit-identical to the single-device transform.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..numeric.limb import mulhi_u32

_U32 = jnp.uint32


def _shoup_lazy32(y, w, wp, q):
    return w * y - q * mulhi_u32(y, wp)


# ---------------------------------------------------------------------------
# Expanded per-lane tables
# ---------------------------------------------------------------------------


def build_expanded_tables32(log_n: int, q: int):
    """Per-lane expanded forward tables ``(log_n, n)`` (u32 path)."""
    from ..golden.model import GoldenNtt

    g = GoldenNtt(log_n, q)
    n = 1 << log_n

    def quot32(w):
        return ((w << 32) // q) & 0xFFFFFFFF

    p_idx = np.arange(n)
    fwd_w = np.zeros((log_n, n), dtype=np.uint32)
    fwd_p = np.zeros((log_n, n), dtype=np.uint32)
    for s in range(log_n):
        m = 1 << s
        t = n >> (s + 1)
        idx = m + p_idx // (2 * t)
        fwd_w[s] = [g.roots[i] for i in idx]
        fwd_p[s] = [quot32(g.roots[i]) for i in idx]
    return jnp.asarray(fwd_w), jnp.asarray(fwd_p)


def build_expanded_inverse_tables32(log_n: int, q: int):
    """Per-lane expanded inverse tables ``(log_n, n)``; the final row holds
    ``inv_n`` on the x half and ``inv_n·w`` on the y half (the fused final
    stage of the single-device convention)."""
    from ..golden.model import GoldenNtt

    g = GoldenNtt(log_n, q)
    n = 1 << log_n

    def quot32(w):
        return ((w << 32) // q) & 0xFFFFFFFF

    p_idx = np.arange(n)
    inv_w = np.zeros((log_n, n), dtype=np.uint32)
    inv_p = np.zeros((log_n, n), dtype=np.uint32)
    for s in range(log_n - 1):
        t = 1 << s
        start = 1 + n - (n >> s)
        idx = start + p_idx // (2 * t)
        inv_w[s] = [g.inv_roots[i] for i in idx]
        inv_p[s] = [quot32(g.inv_roots[i]) for i in idx]
    inv_w[log_n - 1, : n // 2] = g.inv_n
    inv_w[log_n - 1, n // 2 :] = g.inv_n_w
    inv_p[log_n - 1, : n // 2] = quot32(g.inv_n)
    inv_p[log_n - 1, n // 2 :] = quot32(g.inv_n_w)
    return jnp.asarray(inv_w), jnp.asarray(inv_p)


@functools.lru_cache(maxsize=None)
def _default_tables32(log_n: int, q: int):
    return build_expanded_tables32(log_n, q)


@functools.lru_cache(maxsize=None)
def _default_inv_tables32(log_n: int, q: int):
    return build_expanded_inverse_tables32(log_n, q)


@functools.lru_cache(maxsize=None)
def _default_tables64(log_n: int, q: int):
    return build_expanded_tables64(log_n, q)


@functools.lru_cache(maxsize=None)
def _default_inv_tables64(log_n: int, q: int):
    return build_expanded_inverse_tables64(log_n, q)


# ---------------------------------------------------------------------------
# u32 forward
# ---------------------------------------------------------------------------


def coeff_sharded_forward32(
    mesh: Mesh,
    axis: str,
    log_n: int,
    q: int,
    values,  # (..., n) sharded on the last axis over `axis`
    tables=None,
):
    """Forward NTT with the coefficient axis sharded over ``mesh[axis]``.

    Returns bit-reversed canonical output with the same sharding.  The
    first ``log2 D`` stages each perform one bidirectional ``ppermute``;
    the rest are local.  The compiled SPMD program is cached per
    ``(mesh, axis, log_n, q, ndim)``.
    """
    if tables is None:
        tables = _default_tables32(log_n, q)
    fwd_w, fwd_p = tables
    fn = _fwd32_fn(mesh, axis, log_n, q, values.ndim)
    return fn(values, fwd_w, fwd_p)


@functools.lru_cache(maxsize=None)
def _fwd32_fn(mesh: Mesh, axis: str, log_n: int, q: int, nd: int):
    n = 1 << log_n
    d = mesh.shape[axis]
    shard = n // d
    assert shard * d == n and shard >= 1
    log_d = d.bit_length() - 1
    qc = np.uint32(q)
    tqc = np.uint32(2 * q)

    def local_fn(v, w_tab, p_tab):
        # v: (..., shard); w_tab/p_tab: (log_n, shard) local table slices
        dev = jax.lax.axis_index(axis)
        iota = jax.lax.broadcasted_iota(_U32, (1, shard), 1)
        for s in range(log_d):
            t = n >> (s + 1)
            delta = t // shard  # device-step of the partner
            # the butterfly pairing is an XOR-partner swap: every device
            # needs exactly the shard of device i^delta, so ONE swap
            # permutation delivers both directions (halves link traffic vs
            # separate +delta/-delta ppermutes)
            partner = jax.lax.ppermute(v, axis, [(i ^ delta, i) for i in range(d)])
            is_x = (dev & delta) == 0
            x = jnp.where(is_x, v, partner)
            y = jnp.where(is_x, partner, v)
            w = w_tab[s, :][None]
            wp = p_tab[s, :][None]
            tx = jnp.where(x >= tqc, x - tqc, x)
            mm = _shoup_lazy32(y, w, wp, qc)
            v = jnp.where(is_x, tx + mm, tx + tqc - mm)
        # local stages: roll + mask within the shard
        for s in range(log_d, log_n):
            t = n >> (s + 1)
            is_x = (iota & t) == 0
            w = w_tab[s, :][None]
            wp = p_tab[s, :][None]
            r_m = jnp.roll(v, -t, axis=-1)
            r_p = jnp.roll(v, t, axis=-1)
            x = jnp.where(is_x, v, r_p)
            y = jnp.where(is_x, r_m, v)
            tx = jnp.where(x >= tqc, x - tqc, x)
            mm = _shoup_lazy32(y, w, wp, qc)
            v = jnp.where(is_x, tx + mm, tx + tqc - mm)
        v = jnp.where(v >= tqc, v - tqc, v)
        v = jnp.where(v >= qc, v - qc, v)
        return v

    spec_v = P(*([None] * (nd - 1) + [axis]))
    spec_t = P(None, axis)
    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec_v, spec_t, spec_t),
            out_specs=spec_v,
        )
    )


# ---------------------------------------------------------------------------
# u32 inverse
# ---------------------------------------------------------------------------


def coeff_sharded_inverse32(
    mesh: Mesh,
    axis: str,
    log_n: int,
    q: int,
    values,  # (..., n) bit-reversed, [0,2q), sharded on the last axis
    tables=None,
):
    """Inverse NTT (canonical output), coefficient axis sharded.

    Local stages (t = 1 .. shard/2) run first; the ``log2 D`` exchange
    stages follow, the last
    fusing ``inv_n``/``inv_n·w``.  Bit-identical to
    :func:`transforms.ntt.inverse32`.
    """
    if tables is None:
        tables = _default_inv_tables32(log_n, q)
    inv_w, inv_p = tables
    fn = _inv32_fn(mesh, axis, log_n, q, values.ndim)
    return fn(values, inv_w, inv_p)


@functools.lru_cache(maxsize=None)
def _inv32_fn(mesh: Mesh, axis: str, log_n: int, q: int, nd: int):
    n = 1 << log_n
    d = mesh.shape[axis]
    shard = n // d
    assert shard * d == n and shard >= 1 and d >= 2
    log_d = d.bit_length() - 1
    log_shard = log_n - log_d
    qc = np.uint32(q)
    tqc = np.uint32(2 * q)

    def local_fn(v, w_tab, p_tab):
        dev = jax.lax.axis_index(axis)
        iota = jax.lax.broadcasted_iota(_U32, (1, shard), 1)
        for s in range(log_shard):
            t = 1 << s
            is_x = (iota & t) == 0
            w = w_tab[s, :][None]
            wp = p_tab[s, :][None]
            r_m = jnp.roll(v, -t, axis=-1)
            r_p = jnp.roll(v, t, axis=-1)
            x = jnp.where(is_x, v, r_p)
            y = jnp.where(is_x, r_m, v)
            sxy = x + y
            tx = jnp.where(sxy >= tqc, sxy - tqc, sxy)
            dd = x + tqc - y
            mm = _shoup_lazy32(dd, w, wp, qc)
            v = jnp.where(is_x, tx, mm)
        # exchange stages: t = shard .. n/2, partner delta = t // shard
        for s in range(log_shard, log_n):
            t = 1 << s
            delta = t // shard
            last = s == log_n - 1
            # single XOR-partner swap (see forward)
            partner = jax.lax.ppermute(v, axis, [(i ^ delta, i) for i in range(d)])
            is_x = (dev & delta) == 0
            x = jnp.where(is_x, v, partner)
            y = jnp.where(is_x, partner, v)
            w = w_tab[s, :][None]
            wp = p_tab[s, :][None]
            sxy = x + y
            tx = jnp.where(sxy >= tqc, sxy - tqc, sxy)
            dd = x + tqc - y
            if last:
                # fused final stage: both halves multiply by their per-lane
                # table entry (inv_n on the x half, inv_n*w on the y half)
                inp = jnp.where(is_x, tx, dd)
                v = _shoup_lazy32(inp, w, wp, qc)
            else:
                mm = _shoup_lazy32(dd, w, wp, qc)
                v = jnp.where(is_x, tx, mm)
        v = jnp.where(v >= qc, v - qc, v)
        return v

    spec_v = P(*([None] * (nd - 1) + [axis]))
    spec_t = P(None, axis)
    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec_v, spec_t, spec_t),
            out_specs=spec_v,
        )
    )


# ---------------------------------------------------------------------------
# U64 (62-bit-prime) variant
# ---------------------------------------------------------------------------


def build_expanded_tables64(log_n: int, q: int):
    """Per-lane expanded forward tables as U64 pairs ``(log_n, n)``."""
    from ..golden.model import GoldenNtt
    from ..numeric.limb import to_u64_pair

    g = GoldenNtt(log_n, q)
    n = 1 << log_n

    def quot64(w):
        return ((w << 64) // q) & 0xFFFFFFFFFFFFFFFF

    p_idx = np.arange(n)
    fwd_w = np.zeros((log_n, n), dtype=np.uint64)
    fwd_p = np.zeros((log_n, n), dtype=np.uint64)
    for s in range(log_n):
        m = 1 << s
        t = n >> (s + 1)
        idx = m + p_idx // (2 * t)
        fwd_w[s] = [g.roots[i] for i in idx]
        fwd_p[s] = [quot64(g.roots[i]) for i in idx]
    return to_u64_pair(fwd_w), to_u64_pair(fwd_p)


def build_expanded_inverse_tables64(log_n: int, q: int):
    """Per-lane expanded inverse tables as U64 pairs ``(log_n, n)``."""
    from ..golden.model import GoldenNtt
    from ..numeric.limb import to_u64_pair

    g = GoldenNtt(log_n, q)
    n = 1 << log_n

    def quot64(w):
        return ((w << 64) // q) & 0xFFFFFFFFFFFFFFFF

    p_idx = np.arange(n)
    inv_w = np.zeros((log_n, n), dtype=np.uint64)
    inv_p = np.zeros((log_n, n), dtype=np.uint64)
    for s in range(log_n - 1):
        t = 1 << s
        start = 1 + n - (n >> s)
        idx = start + p_idx // (2 * t)
        inv_w[s] = [g.inv_roots[i] for i in idx]
        inv_p[s] = [quot64(g.inv_roots[i]) for i in idx]
    inv_w[log_n - 1, : n // 2] = g.inv_n
    inv_w[log_n - 1, n // 2 :] = g.inv_n_w
    inv_p[log_n - 1, : n // 2] = quot64(g.inv_n)
    inv_p[log_n - 1, n // 2 :] = quot64(g.inv_n_w)
    return to_u64_pair(inv_w), to_u64_pair(inv_p)


def _u64_exchange_ctx(q: int):
    """Shared constants/helpers for the u64 exchange stages."""
    from ..numeric.limb import (
        U64,
        u64_add,
        u64_mul_hi,
        u64_mul_lo,
        u64_select,
        u64_sub,
    )

    q_lo = np.uint32(q & 0xFFFFFFFF)
    q_hi = np.uint32((q >> 32) & 0xFFFFFFFF)
    tq_lo = np.uint32((2 * q) & 0xFFFFFFFF)
    tq_hi = np.uint32(((2 * q) >> 32) & 0xFFFFFFFF)

    def u64c(lo, hi, shape):
        return U64(jnp.full(shape, lo, _U32), jnp.full(shape, hi, _U32))

    def shoup(y, w, wp, qq):
        return u64_sub(u64_mul_lo(w, y), u64_mul_lo(qq, u64_mul_hi(y, wp)))

    def consts(shape=(1, 1)):
        return u64c(q_lo, q_hi, shape), u64c(tq_lo, tq_hi, shape)

    return U64, u64_add, u64_sub, u64_select, shoup, consts


def coeff_sharded_forward64(mesh, axis, log_n, q, values, tables=None):
    """U64 forward NTT with the coefficient axis sharded over the mesh.

    ``values``: :class:`U64` with shape ``(..., n)`` sharded on the last
    axis.  Same structure as the u32 variant: ``log2 D`` ppermute stages,
    then shard-local stages; bit-identical to
    the single-device transform.
    """
    if tables is None:
        tables = _default_tables64(log_n, q)
    fwd_w, fwd_p = tables
    fn = _fwd64_fn(mesh, axis, log_n, q, values.lo.ndim)
    lo, hi = fn(values.lo, values.hi, fwd_w.lo, fwd_w.hi, fwd_p.lo, fwd_p.hi)
    from ..numeric.limb import U64

    return U64(lo, hi)


@functools.lru_cache(maxsize=None)
def _fwd64_fn(mesh, axis: str, log_n: int, q: int, nd: int):
    n = 1 << log_n
    d = mesh.shape[axis]
    shard = n // d
    assert shard * d == n and shard >= 1
    log_d = d.bit_length() - 1
    U64, u64_add, u64_sub, u64_select, shoup, consts = _u64_exchange_ctx(q)
    from ..modular.modops import reduce_once64, reduce_twice64

    def local_fn(vlo, vhi, wlo, whi, plo, phi):
        v = U64(vlo, vhi)
        dev = jax.lax.axis_index(axis)
        iota = jax.lax.broadcasted_iota(_U32, (1, shard), 1)
        qq, tq = consts()

        def butterfly(x, y, w, wp):
            tx = reduce_once64(x, tq)
            mm = shoup(y, w, wp, qq)
            return u64_add(tx, mm), u64_sub(u64_add(tx, tq), mm)

        for s in range(log_d):
            t = n >> (s + 1)
            delta = t // shard
            # single XOR-partner swap per stage (see the u32 forward)
            perm = [(i ^ delta, i) for i in range(d)]
            partner = U64(
                jax.lax.ppermute(v.lo, axis, perm),
                jax.lax.ppermute(v.hi, axis, perm),
            )
            is_x = (dev & delta) == 0
            x = u64_select(is_x, v, partner)
            y = u64_select(is_x, partner, v)
            w = U64(wlo[s][None], whi[s][None])
            wp = U64(plo[s][None], phi[s][None])
            nx, ny = butterfly(x, y, w, wp)
            v = u64_select(is_x, nx, ny)
        for s in range(log_d, log_n):
            t = n >> (s + 1)
            is_x = (iota & t) == 0
            r_m = U64(jnp.roll(v.lo, -t, -1), jnp.roll(v.hi, -t, -1))
            r_p = U64(jnp.roll(v.lo, t, -1), jnp.roll(v.hi, t, -1))
            x = u64_select(is_x, v, r_p)
            y = u64_select(is_x, r_m, v)
            w = U64(wlo[s][None], whi[s][None])
            wp = U64(plo[s][None], phi[s][None])
            nx, ny = butterfly(x, y, w, wp)
            v = u64_select(is_x, nx, ny)
        v = reduce_twice64(v, qq, tq)
        return v.lo, v.hi

    spec_v = P(*([None] * (nd - 1) + [axis]))
    spec_t = P(None, axis)
    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec_v, spec_v, spec_t, spec_t, spec_t, spec_t),
            out_specs=(spec_v, spec_v),
        )
    )


def coeff_sharded_inverse64(mesh, axis, log_n, q, values, tables=None):
    """U64 inverse NTT (canonical output), coefficient axis sharded.

    ``values``: :class:`U64` bit-reversed in ``[0, 2q)``.  Local stages
    first, then ppermute exchanges with
    the fused ``inv_n`` final stage; bit-identical to
    :func:`transforms.ntt.inverse64`.
    """
    if tables is None:
        tables = _default_inv_tables64(log_n, q)
    inv_w, inv_p = tables
    fn = _inv64_fn(mesh, axis, log_n, q, values.lo.ndim)
    lo, hi = fn(values.lo, values.hi, inv_w.lo, inv_w.hi, inv_p.lo, inv_p.hi)
    from ..numeric.limb import U64

    return U64(lo, hi)


@functools.lru_cache(maxsize=None)
def _inv64_fn(mesh, axis: str, log_n: int, q: int, nd: int):
    n = 1 << log_n
    d = mesh.shape[axis]
    shard = n // d
    assert shard * d == n and shard >= 1 and d >= 2
    log_d = d.bit_length() - 1
    log_shard = log_n - log_d
    U64, u64_add, u64_sub, u64_select, shoup, consts = _u64_exchange_ctx(q)
    from ..modular.modops import reduce_once64

    def local_fn(vlo, vhi, wlo, whi, plo, phi):
        v = U64(vlo, vhi)
        dev = jax.lax.axis_index(axis)
        iota = jax.lax.broadcasted_iota(_U32, (1, shard), 1)
        qq, tq = consts()
        for s in range(log_shard):
            t = 1 << s
            is_x = (iota & t) == 0
            r_m = U64(jnp.roll(v.lo, -t, -1), jnp.roll(v.hi, -t, -1))
            r_p = U64(jnp.roll(v.lo, t, -1), jnp.roll(v.hi, t, -1))
            x = u64_select(is_x, v, r_p)
            y = u64_select(is_x, r_m, v)
            w = U64(wlo[s][None], whi[s][None])
            wp = U64(plo[s][None], phi[s][None])
            tx = reduce_once64(u64_add(x, y), tq)
            dd = u64_sub(u64_add(x, tq), y)
            mm = shoup(dd, w, wp, qq)
            v = u64_select(is_x, tx, mm)
        for s in range(log_shard, log_n):
            t = 1 << s
            delta = t // shard
            last = s == log_n - 1
            # single XOR-partner swap per stage (see the u32 forward)
            perm = [(i ^ delta, i) for i in range(d)]
            partner = U64(
                jax.lax.ppermute(v.lo, axis, perm),
                jax.lax.ppermute(v.hi, axis, perm),
            )
            is_x = (dev & delta) == 0
            x = u64_select(is_x, v, partner)
            y = u64_select(is_x, partner, v)
            w = U64(wlo[s][None], whi[s][None])
            wp = U64(plo[s][None], phi[s][None])
            tx = reduce_once64(u64_add(x, y), tq)
            dd = u64_sub(u64_add(x, tq), y)
            if last:
                inp = u64_select(is_x, tx, dd)
                v = shoup(inp, w, wp, qq)
            else:
                mm = shoup(dd, w, wp, qq)
                v = u64_select(is_x, tx, mm)
        v = reduce_once64(v, qq)
        return v.lo, v.hi

    spec_v = P(*([None] * (nd - 1) + [axis]))
    spec_t = P(None, axis)
    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(spec_v, spec_v, spec_t, spec_t, spec_t, spec_t),
            out_specs=(spec_v, spec_v),
        )
    )
