"""Blind rotation over an RNS (DCRT) accumulator — the 62-bit-tier
bootstrap pipeline (BFV/FHEW-flavored).

Where the torus pipeline rotates in the coefficient domain, the DCRT
accumulator lives in the NTT domain, so ``acc * X^d`` is one *pointwise*
multiply by the monomial diagonal (``transforms.dcrt.dcrt_monomial64``).
Each CMux step is:

    rotated = acc ⊙ NTT(X^d)                     (pointwise, per modulus)
    diff    = rotated - acc                      (NTT domain)
    delta   = INTT(diff) gadget-⊡ GGSW_i         (lattice.dcrt pipeline:
              compose -> multi-limb decompose -> respread -> NTT -> MAC)
    acc    += delta

This is the composition SURVEY.md §3.4 points at (``DcrtGlwe::
add_dcrt_glev_mul_crt_poly_assign`` as the inner op of a rotation loop).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..decompose.big_integer import BigUintApproxSignedBasis
from ..lattice.dcrt import crt_glwe_mul_dcrt_ggsw
from ..modular.modops import add64, mul64, sub64
from ..numeric.limb import U64
from ..rns.base import RNSBase64
from ..transforms.dcrt import DcrtPlan64, dcrt_inverse64, dcrt_monomial64

_U32 = jnp.uint32


def _m_bc(rns_base, extra):
    return jax.tree.map(
        lambda x: x.reshape((rns_base.count,) + (1,) * extra), rns_base.modulus
    )


@functools.partial(jax.jit, static_argnums=(1, 2))
def _rotate_core(
    plan: DcrtPlan64,
    basis: BigUintApproxSignedBasis,
    rns_base: RNSBase64,
    bsk,  # U64 (n_lwe, k+1, L, n_mod, k+1, N) — DcrtGgsw(s_i), NTT domain
    lwe_switched,  # (B, n_lwe + 1) int32 mod 2N
    acc0,  # U64 (n_mod, B, k+1, N) — initial accumulators, NTT domain
) -> U64:
    """Batched rotation in the residue-major internal layout: the whole
    ciphertext batch rides ONE batched NTT per step (vs the reference's
    one-ciphertext loop, glwe/dcrt.rs:178-343)."""
    n_lwe = bsk.lo.shape[0]
    n = plan.n
    m = _m_bc(rns_base, 3)

    b = lwe_switched[:, n_lwe]  # (B,)
    mono_b = dcrt_monomial64(plan, ((-b) % (2 * n))[:, None])  # (n_mod, B, N)
    mb = U64(mono_b.lo[:, :, None, :], mono_b.hi[:, :, None, :])
    acc = mul64(acc0, mb, m)

    def body(acc, x):
        a_i, bsk_lo, bsk_hi = x  # a_i (B,)
        mono = dcrt_monomial64(plan, (a_i % (2 * n))[:, None])
        mo = U64(mono.lo[:, :, None, :], mono.hi[:, :, None, :])
        rotated = mul64(acc, mo, m)
        diff_ntt = sub64(rotated, acc, m.value)
        diff = dcrt_inverse64(plan, diff_ntt)  # (n_mod, B, k+1, N)
        delta = crt_glwe_mul_dcrt_ggsw(
            diff, U64(bsk_lo, bsk_hi), basis, plan, rns_base
        )
        return add64(acc, delta, m.value), None

    a_t = jnp.swapaxes(lwe_switched[:, :n_lwe], 0, 1)  # (n_lwe, B)
    acc, _ = jax.lax.scan(body, acc, (a_t, bsk.lo, bsk.hi))
    return acc


def dcrt_blind_rotate(
    plan: DcrtPlan64,
    basis: BigUintApproxSignedBasis,
    rns_base: RNSBase64,
    bsk,
    lwe_switched,  # (n_lwe + 1,) int32 mod 2N
    acc0,  # U64 (n_mod, k+1, N)
) -> U64:
    """Single-ciphertext rotation; returns the accumulator (NTT domain)."""
    out = _rotate_core(
        plan,
        basis,
        rns_base,
        bsk,
        lwe_switched[None],
        U64(acc0.lo[:, None], acc0.hi[:, None]),
    )
    return U64(out.lo[:, 0], out.hi[:, 0])


def dcrt_blind_rotate_batched(plan, basis, rns_base, bsk, lwe_batch, acc_batch: U64) -> U64:
    """Batched RNS blind rotation: ``lwe_batch (B, n_lwe+1)``,
    ``acc_batch U64 (B, n_mod, k+1, N)`` — the batch is moved inside the
    residue-major layout so every per-modulus NTT transforms ``B*(k+1)``
    polynomials in one batched call (the bootstrap key is shared)."""
    acc0 = U64(
        jnp.swapaxes(acc_batch.lo, 0, 1), jnp.swapaxes(acc_batch.hi, 0, 1)
    )
    out = _rotate_core(plan, basis, rns_base, bsk, lwe_batch, acc0)
    return U64(jnp.swapaxes(out.lo, 0, 1), jnp.swapaxes(out.hi, 0, 1))
