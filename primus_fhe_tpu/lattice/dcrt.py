"""DCRT (RNS + NTT domain) gadget products — the BFV-flavored path.

Reference: ``crates/primus_lattice/src/glwe/dcrt.rs:178-343``
(``add_dcrt_glev_mul_crt_poly_assign``) and ``src/glwe/crt.rs:200``
(``CrtGlwe::mul_dcrt_ggsw_to``).  Pipeline per decomposition level
(SURVEY.md §3.4):

    compose residues -> big ints        (one-time, before the level loop)
    unsigned digit extract + carries    (multi-limb window)
    centered re-spread into all moduli  (wrapping_decompose_small)
    one NTT per modulus                 (DCRT forward, batched)
    pointwise modular FMA accumulate    (per limb, per GLWE component)

Layouts (all U64 pairs):
- ``CrtGlwe``   coeff domain:  ``(n_mod, k+1, N)``
- ``DcrtGlwe``  NTT domain:    ``(n_mod, k+1, N)``
- ``DcrtGlev``  NTT domain:    ``(level, n_mod, k+1, N)``
- ``DcrtGgsw``  NTT domain:    ``(k+1, level, n_mod, k+1, N)``

The ``n_mod`` axis is the shard axis: everything here except ``compose``
(a residue-axis contraction -> psum when sharded) is residue-local.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..modular.modops import add64, mul64
from ..numeric.limb import U64
from ..rns.base import RNSBase64
from ..transforms.dcrt import DcrtPlan64, dcrt_forward64, dcrt_inverse64

_U32 = jnp.uint32


def _m_bc(rns_base: RNSBase64, extra: int):
    """Barrett record broadcast to (n_mod, 1...)."""
    shape = (rns_base.count,) + (1,) * extra
    return jax.tree.map(lambda x: x.reshape(shape), rns_base.modulus)


def _digits_to_dcrt(digit_u32, basis, rns_base, plan, out_factor=1):
    """One level's digits ``(..., N)`` u32 -> NTT-domain residues
    ``U64 (n_mod, ..., N)`` via the centered lift (base.rs:279)."""
    d64 = U64(digit_u32, jnp.zeros_like(digit_u32))
    residues = rns_base.wrapping_decompose_small(d64, basis.basis)
    return dcrt_forward64(plan, residues, out_factor)


@functools.partial(jax.jit, static_argnums=(3, 5))
def add_dcrt_glev_mul_crt_poly(
    acc,  # U64 (n_mod, ..., k+1, N) NTT domain (optional batch dims)
    glev,  # U64 (level, n_mod, k+1, N) NTT domain (shared across batch)
    crt_poly,  # U64 (n_mod, ..., N) coeff domain residues
    basis: BigUintApproxSignedBasis,
    plan: DcrtPlan64,
    rns_base: RNSBase64,
) -> U64:
    """``acc += glev * gadget_decompose(crt_poly)`` (dcrt.rs:178-260).

    Rank-polymorphic over batch dims between the residue and coefficient
    axes: every NTT call then carries the whole ``batch*(k+1)`` poly block
    in ONE batched transform (the answer to the reference's
    one-ciphertext-at-a-time loop)."""
    extra = crt_poly.lo.ndim - 2  # batch dims between n_mod and N
    k1 = acc.lo.shape[-2]
    n_mod = rns_base.count
    n = crt_poly.lo.shape[-1]

    # 1. CRT compose: residues -> (..., N, L) big-int coefficients.
    big = rns_base.compose(crt_poly)

    # 2. carry init + per-level unsigned digits.
    v, carries = basis.init_value_carry(big)

    m = _m_bc(rns_base, extra + 2)
    g_shape = (n_mod,) + (1,) * extra + (k1, n)
    for lvl in range(basis.decompose_length):
        digit, carries = basis.unsigned_decompose_level(v, carries, lvl)
        f = _digits_to_dcrt(digit, basis, rns_base, plan)  # (n_mod, ..., N)
        f = U64(f.lo[..., None, :], f.hi[..., None, :])  # broadcast over k+1
        g = U64(
            glev.lo[lvl].reshape(g_shape), glev.hi[lvl].reshape(g_shape)
        )  # broadcast over batch
        prod = mul64(g, f, m)
        acc = add64(acc, prod, m.value)
    return acc


@functools.partial(jax.jit, static_argnums=(2, 4))
def crt_glwe_mul_dcrt_ggsw(
    crt_glwe,  # U64 (n_mod, ..., k+1, N) coeff-domain residues
    ggsw,  # U64 (k+1, level, n_mod, k+1, N) NTT domain
    basis: BigUintApproxSignedBasis,
    plan: DcrtPlan64,
    rns_base: RNSBase64,
) -> U64:
    """External product in the RNS domain (crt.rs:200): each input
    component feeds one GLev row.  Returns a DcrtGlwe ``(n_mod, ..., k+1,
    N)`` in the NTT domain (batch dims pass through)."""
    k1 = crt_glwe.lo.shape[-2]
    acc = U64(
        jnp.zeros_like(crt_glwe.lo), jnp.zeros_like(crt_glwe.hi)
    )
    for r in range(k1):
        poly_r = U64(crt_glwe.lo[..., r, :], crt_glwe.hi[..., r, :])
        glev_r = U64(ggsw.lo[r], ggsw.hi[r])
        acc = add_dcrt_glev_mul_crt_poly(acc, glev_r, poly_r, basis, plan, rns_base)
    return acc


@functools.partial(jax.jit, static_argnums=(2,))
def dcrt_glwe_mul_poly(acc, dcrt_poly, rns_base: RNSBase64):
    """``acc * poly`` pointwise per modulus (dcrt.rs:108)."""
    m = _m_bc(rns_base, 2)
    p = U64(dcrt_poly.lo[:, None, :], dcrt_poly.hi[:, None, :])
    return mul64(acc, p, m)


@functools.partial(jax.jit, static_argnums=(3,))
def dcrt_glwe_butterfly_mul(a, rhs, dcrt_poly, rns_base: RNSBase64):
    """``(a, out) = (a + rhs, (a - rhs) * poly)`` — the CMux-shaped
    inverse butterfly of dcrt.rs:130-150."""
    from ..modular.modops import sub64

    m = _m_bc(rns_base, 2)
    s = add64(a, rhs, m.value)
    d = sub64(a, rhs, m.value)
    p = U64(dcrt_poly.lo[:, None, :], dcrt_poly.hi[:, None, :])
    return s, mul64(d, p, m)


# ---------------------------------------------------------------------------
# DCRT GLWE encryption (the RNS analogue of rlwe.generate_random_zero_sample,
# coeff.rs:92-121, with CRT-replicated noise per primus_distr common.rs)
# ---------------------------------------------------------------------------


def dcrt_glwe_zero_sample(key, secret_ntt, gaussian, plan: DcrtPlan64, rns_base: RNSBase64):
    """DcrtGlwe encryption of zero, NTT domain: ``(a_1..a_k, sum a_i s_i + e)``.

    ``secret_ntt``: U64 ``(n_mod, k, N)`` NTT-domain secret polynomials
    (the same logical polys under every modulus).  Mask polys are uniform
    mod Q — independent uniform residues per modulus ARE uniform mod Q by
    the CRT bijection.  Noise is sampled once and centered into every
    modulus (CRT-replicated, ``src/common.rs:129-350``).
    """
    import jax as _jax

    from ..distr.sampling import DiscreteGaussian

    n_mod, k, n = secret_ntt.lo.shape
    ka, ke = _jax.random.split(key)
    # uniform residues via multiply-shift per modulus
    keys_a = _jax.random.split(ka, n_mod * k).reshape(n_mod, k, 2)
    a_lo = []
    a_hi = []
    from ..distr.sampling import sample_uniform_u64

    for mi, q in enumerate(rns_base.moduli_ints):
        row_lo, row_hi = [], []
        for ki in range(k):
            s = sample_uniform_u64(keys_a[mi, ki], (n,), q)
            row_lo.append(s.lo)
            row_hi.append(s.hi)
        a_lo.append(jnp.stack(row_lo))
        a_hi.append(jnp.stack(row_hi))
    a = U64(jnp.stack(a_lo), jnp.stack(a_hi))  # (n_mod, k, N) coeff domain

    fa = dcrt_forward64(plan, a)
    m = _m_bc(rns_base, 2)
    prods = mul64(fa, secret_ntt, m)
    # sum over the k mask polys
    acc = U64(prods.lo[:, 0], prods.hi[:, 0])
    m1 = _m_bc(rns_base, 1)
    for ki in range(1, k):
        acc = add64(acc, U64(prods.lo[:, ki], prods.hi[:, ki]), m1.value)
    b_coeff = dcrt_inverse64(plan, U64(acc.lo[:, None], acc.hi[:, None]))
    b_coeff = U64(b_coeff.lo[:, 0], b_coeff.hi[:, 0])  # (n_mod, N)

    # CRT-replicated gaussian noise
    g_signed = gaussian.sample_signed(ke, (n,))  # int32
    qs = rns_base.modulus.value  # U64 (n_mod,)
    from ..numeric.limb import u64_add, u64_select

    e_pos = U64(
        jnp.broadcast_to(g_signed.astype(jnp.uint32)[None], (n_mod, n)),
        jnp.zeros((n_mod, n), jnp.uint32),
    )
    sign_ext = U64(
        jnp.broadcast_to(g_signed.astype(jnp.uint32)[None], (n_mod, n)),
        jnp.broadcast_to((g_signed >> 31).astype(jnp.uint32)[None], (n_mod, n)),
    )
    qb = U64(qs.lo[:, None] + jnp.zeros((1, n), jnp.uint32), qs.hi[:, None] + jnp.zeros((1, n), jnp.uint32))
    e_neg = u64_add(qb, sign_ext)
    e = u64_select(jnp.broadcast_to((g_signed < 0)[None], (n_mod, n)), e_neg, e_pos)

    b = add64(b_coeff, e, m1.value)
    b_ntt = dcrt_forward64(plan, U64(b.lo[:, None], b.hi[:, None]))
    return U64(
        jnp.concatenate([fa.lo, b_ntt.lo], axis=1),
        jnp.concatenate([fa.hi, b_ntt.hi], axis=1),
    )  # (n_mod, k+1, N) NTT domain


def dcrt_glwe_phase(glwe_ntt: U64, secret_ntt: U64, plan: DcrtPlan64, rns_base: RNSBase64) -> U64:
    """``b - sum a_i s_i`` per modulus, coefficient domain."""
    n_mod, k1, n = glwe_ntt.lo.shape
    k = k1 - 1
    m = _m_bc(rns_base, 2)
    a = U64(glwe_ntt.lo[:, :k], glwe_ntt.hi[:, :k])
    b = U64(glwe_ntt.lo[:, k], glwe_ntt.hi[:, k])
    prods = mul64(a, secret_ntt, m)
    acc = U64(prods.lo[:, 0], prods.hi[:, 0])
    m1 = _m_bc(rns_base, 1)
    for ki in range(1, k):
        acc = add64(acc, U64(prods.lo[:, ki], prods.hi[:, ki]), m1.value)
    from ..modular.modops import sub64

    diff = sub64(b, acc, m1.value)
    out = dcrt_inverse64(plan, U64(diff.lo[:, None], diff.hi[:, None]))
    return U64(out.lo[:, 0], out.hi[:, 0])


def dcrt_ggsw_encrypt(key, mu: int, secret_ntt, basis, gaussian, plan, rns_base):
    """DcrtGgsw(mu): row r level l = zero-sample + mu * scalar_l at comp r.

    ``mu`` is a small scalar message (the bootstrap-key case).  Returns
    U64 ``(k+1, L, n_mod, k+1, N)`` in the NTT domain.
    """
    import jax as _jax

    n_mod, k, n = secret_ntt.lo.shape
    level = basis.decompose_length
    keys = _jax.random.split(key, (k + 1) * level)
    rows_lo, rows_hi = [], []
    idx = 0
    for r in range(k + 1):
        lev_lo, lev_hi = [], []
        for l in range(level):
            z = dcrt_glwe_zero_sample(keys[idx], secret_ntt, gaussian, plan, rns_base)
            idx += 1
            if mu:
                # add mu * scalar_l * delta(X) at component r: in NTT domain a
                # constant polynomial is constant across slots.
                import numpy as _np

                const = _np.array(
                    [mu * basis.scalar_ints[l] % q for q in rns_base.moduli_ints],
                    dtype=_np.uint64,
                )
                from ..numeric.limb import to_u64_pair as _tp

                cu = _tp(const)
                m1 = _m_bc(rns_base, 1)
                comp = U64(z.lo[:, r], z.hi[:, r])
                comp = add64(
                    comp,
                    U64(
                        jnp.broadcast_to(cu.lo[:, None], (n_mod, n)),
                        jnp.broadcast_to(cu.hi[:, None], (n_mod, n)),
                    ),
                    m1.value,
                )
                z = U64(z.lo.at[:, r].set(comp.lo), z.hi.at[:, r].set(comp.hi))
            lev_lo.append(z.lo)
            lev_hi.append(z.hi)
        rows_lo.append(jnp.stack(lev_lo))
        rows_hi.append(jnp.stack(lev_hi))
    return U64(jnp.stack(rows_lo), jnp.stack(rows_hi))
