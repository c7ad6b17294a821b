"""NTRU (NGS / FINAL-style) blind rotation — the FHEW variant.

The reference ships the NTRU container mechanics only
(``crates/primus_lattice/src/ntru/{coeff,ntt}.rs``: NTT conversion,
pointwise/scalar/factor multiply, ``c*f`` phase) and leaves the
bootstrapping composition to callers (SURVEY.md §1).  This module is that
composition, in the FINAL shape (Bonte et al., "FINAL: Faster FHE
instantiated with NTRU and LWE"):

- **scalar NTRU ciphertext** of a polynomial ``mu``: ``c = g/f + mu`` over
  ``R_q = Z_q[X]/(X^N+1)`` with secret ``f = 1 + 4 f'`` (ternary ``f'``),
  so the phase ``c*f = g + mu*f ≡ g + mu  (mod 4Δ ≈ q)`` decodes ``mu``;
- **vector NGS ciphertext** of a bit ``s``: rows ``C_j = g_j/f + B^j s``
  aligned with the gadget scalars of :class:`ApproxSignedBasis32`;
- **external product** ``c ⊠ C = Σ_j digit_j(c) · C_j ≈ c·s + noise`` —
  signed decomposition, one forward NTT per digit, pointwise MAC;
- **CMux chain** ``acc ← acc + (X^{a_i} − 1) · (acc ⊠ EVK_i)``, i.e.
  ``acc·X^{a_i s_i}`` — the monomial factor is applied *in the NTT
  domain* (one pointwise multiply via the ordinal-root table) so each
  step costs L forward NTTs + 1 inverse NTT, exactly mirroring the
  RLWE path's transform economy;
- **LWE extraction** under the key ``f`` (constant coefficient of
  ``acc·f``), ready for an LWE→LWE key switch back to the caller's key.

Everything is mod one NTT prime ``q < 2^30`` (uint32 path) — half the
ciphertext size of an RLWE accumulator with the same N, the headline win
of NTRU bootstrapping.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian
from ..modular.modops import (
    add32,
    barrett_lazy_reduce32,
    dot32,
    lazy_mul32,
    neg32,
    reduce_once32,
    sub32,
)
from ..modular.modulus import BarrettModulus32, barrett32
from ..transforms.ntt import forward32, inverse32
from ..transforms.plan import build_plan32

_U32 = jnp.uint32


class NtruContext:
    """Static NTRU bootstrap context: ring plan, modulus record, gadget.

    Plain class (identity hash) so it can ride ``jit`` static args, like
    :class:`TorusConvolver32`.
    """

    def __init__(self, log_n: int, q: int, log_basis: int, level: int, t_scale: int = 4):
        if (q - 1) % t_scale != 0:
            raise ValueError("t_scale must divide q - 1 (q ≡ 1 mod 2N covers 4/8/…)")
        self.plan = build_plan32(log_n, q)
        self.m = barrett32(q)
        self.q_int = q
        self.log_basis = log_basis
        self.level = level
        self.t_scale = t_scale  # f = 1 + t·f'; messages live in ((q-1)/t)·Z_t
        self.delta = (q - 1) // t_scale
        self.basis = ApproxSignedBasis32(q, log_basis, level)

    @property
    def n(self) -> int:
        return self.plan.n


def make_ntru_context(log_n: int, q: int, log_basis: int, level: int) -> NtruContext:
    return NtruContext(log_n, q, log_basis, level)


# ---------------------------------------------------------------------------
# Key generation (cold path; pointwise inverse runs host-side, §3.1 pattern)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NtruSecret:
    """``f = 1 + 4 f'`` with its NTT form and pointwise NTT-domain inverse."""

    f: jnp.ndarray  # (N,) coeff mod q
    f_ntt: jnp.ndarray  # (N,) canonical
    f_inv_ntt: jnp.ndarray  # (N,) canonical


def ntru_keygen(key, ctx: NtruContext) -> NtruSecret:
    """Samples ternary ``f'``, retries until ``f = 1 + t·f'`` is invertible.

    ``t = ctx.t_scale`` (4 for 2-bit messages, 8 for boolean-gate ±q/8
    encodings).  The phase trick: for ``mu = c·(q-1)/t``, ``t·mu ≡ -c`` so
    ``mu·f ≡ mu - c·f' (mod q)`` — message preserved up to a ternary-small
    error.  Invertibility in ``R_q`` ⇔ every NTT coordinate is nonzero; the
    inverse is the pointwise Fermat inverse computed exactly on the host
    (one-time cost, like root-table construction).
    """
    q = ctx.q_int
    n = ctx.n
    rng = np.random.default_rng(np.asarray(jax.random.key_data(key)).ravel())
    for _ in range(64):
        fp = rng.integers(-1, 2, size=n)
        f = (ctx.t_scale * fp) % q
        f[0] = (f[0] + 1) % q  # f = 1 + t·f': the +1 is the constant term
        f_dev = jnp.asarray(f.astype(np.uint32))
        f_ntt = np.asarray(forward32(ctx.plan, f_dev))
        if np.all(f_ntt != 0):
            inv = np.array([pow(int(x), q - 2, q) for x in f_ntt], dtype=np.uint32)
            return NtruSecret(
                f=f_dev, f_ntt=jnp.asarray(f_ntt), f_inv_ntt=jnp.asarray(inv)
            )
    raise RuntimeError("no invertible NTRU secret found (q too small?)")


# ---------------------------------------------------------------------------
# Scalar / vector encryption
# ---------------------------------------------------------------------------


def ntru_encrypt_poly(key, ctx: NtruContext, sk: NtruSecret, mu, gaussian: DiscreteGaussian):
    """``c = g/f + mu`` with Gaussian ``g`` (``mu``: (..., N) mod q)."""
    g = gaussian.sample_mod(key, mu.shape, ctx.q_int)
    gf = inverse32(ctx.plan, lazy_mul32(forward32(ctx.plan, g), sk.f_inv_ntt, ctx.m))
    return add32(gf, jnp.asarray(mu, _U32), ctx.m.value)


def ntru_phase(ctx: NtruContext, sk: NtruSecret, c):
    """``c * f`` — decryption phase (ntru/ntt.rs:36-108 composite)."""
    return inverse32(ctx.plan, lazy_mul32(forward32(ctx.plan, c), sk.f_ntt, ctx.m))


def ngs_encrypt_bit(key, ctx: NtruContext, sk: NtruSecret, bit, gaussian: DiscreteGaussian):
    """Vector NGS ciphertext of ``bit``: rows ``g_j/f + B^j·2^drop·bit``.

    Returns coeff form ``(L, N)``; gadget scalars match the signed
    decomposition so that ``c ⊠ rows ≈ c · bit``.
    """
    basis = ctx.basis
    level = basis.decompose_length
    n = ctx.n
    scal = jnp.asarray(
        np.array([s % ctx.q_int for s in basis.scalars], dtype=np.uint32)
    )  # (L,)
    bit = jnp.asarray(bit, _U32)
    mu = jnp.zeros((level, n), dtype=_U32)
    mu = mu.at[:, 0].set(lazy_mul32(scal, jnp.broadcast_to(bit, scal.shape), ctx.m))
    mu = reduce_once32(mu, ctx.m.value)
    keys = jax.random.split(key, level)
    return jax.vmap(
        lambda kk, row: ntru_encrypt_poly(kk, ctx, sk, row, gaussian)
    )(keys, mu)


def make_ntru_bootstrap_key(key, ctx: NtruContext, sk: NtruSecret, lwe_secret, gaussian):
    """EVK_i = NGS(s_i) in NTT form, stacked ``(n_lwe, L, N)``.

    ``lwe_secret``: (n_lwe,) bits as uint32 (binary LWE key, the FHEW/FINAL
    setting).
    """
    n_lwe = int(lwe_secret.shape[0])
    keys = jax.random.split(key, n_lwe)
    evk = jax.vmap(
        lambda kk, s_i: ngs_encrypt_bit(kk, ctx, sk, s_i, gaussian)
    )(keys, lwe_secret)  # (n_lwe, L, N) coeff
    return forward32(ctx.plan, evk)


# ---------------------------------------------------------------------------
# External product and blind rotation
# ---------------------------------------------------------------------------


def _external_product_ntt(ctx: NtruContext, basis, acc, evk_ntt_i):
    """NTT-domain ``acc ⊠ EVK_i``: decompose → NTT → MAC.

    ``acc``: ``(..., N)`` coeff mod q; ``evk_ntt_i``: ``(L, N)``.
    Returns the NTT-domain product ``(..., N)`` canonical.

    MAC uses the wrap-exact raw-u32 accumulation (canonical terms < q <
    2^30 sum exactly in uint32 up to 4 terms before one Barrett pass) —
    the same trick as the RLWE tail (`lattice/tfhe.py`).
    """
    level = basis.decompose_length
    digits = basis.decompose(acc)  # (L, ..., N) canonical mod q
    f = forward32(ctx.plan, digits)  # (L, ..., N) canonical
    acc_sum = None
    pending = 0
    for l in range(level):
        t = lazy_mul32(f[l], evk_ntt_i[l], ctx.m)
        t = reduce_once32(t, ctx.m.value)
        if acc_sum is None:
            acc_sum, pending = t, 1
        else:
            if pending == 4:
                acc_sum = reduce_once32(
                    barrett_lazy_reduce32(acc_sum, ctx.m), ctx.m.value
                )
                pending = 1
            acc_sum = acc_sum + t
            pending += 1
    return reduce_once32(barrett_lazy_reduce32(acc_sum, ctx.m), ctx.m.value)


def rotate_poly_q(poly, degree, n: int, q):
    """``poly * X^degree`` mod ``(X^N + 1, q)`` — conditional static
    rolls (shared bit-chain rotation, `poly.poly.poly_rotate32`)."""
    from ..poly.poly import poly_rotate32

    return poly_rotate32(poly, degree, q)


@functools.partial(jax.jit, static_argnums=(0,))
def ntru_blind_rotate(ctx: NtruContext, evk_ntt, lwe_switched, test_poly):
    """Returns the rotated accumulator ``(..., N)`` mod q.

    ``evk_ntt``: ``(n_lwe, L, N)``; ``lwe_switched``: ``(..., n_lwe+1)``
    int32 mod 2N; ``test_poly``: ``(N,)`` mod q (typically ``Δ·v``).

    ``acc = v·X^{-b}``; per mask element
    ``acc ← acc + rot(INTT(acc ⊠ EVK_i), a_i) − INTT(acc ⊠ EVK_i)``
    — the ``(X^{a_i} − 1)`` factor is applied as a coefficient-domain
    conditional-roll rotation AFTER the inverse NTT, the same bit-chain
    rotation as the RLWE path, instead of an NTT-domain monomial multiply
    whose ordinal-root lookup is a data-dependent gather.
    """
    n_lwe = evk_ntt.shape[0]
    n = ctx.n
    basis = ctx.basis
    batch = lwe_switched.shape[:-1]

    b = lwe_switched[..., n_lwe]
    acc = rotate_poly_q(jnp.broadcast_to(test_poly, batch + (n,)), -b, n, ctx.m.value)

    def body(acc, x):
        a_i, evk_i = x
        ep = _external_product_ntt(ctx, basis, acc, evk_i)  # NTT domain
        delta = inverse32(ctx.plan, ep)
        rot = rotate_poly_q(delta, a_i, n, ctx.m.value)
        return add32(acc, sub32(rot, delta, ctx.m.value), ctx.m.value), None

    a_t = jnp.moveaxis(lwe_switched[..., :n_lwe], -1, 0)  # (n_lwe, ...)
    acc, _ = jax.lax.scan(body, acc, (a_t, evk_ntt))
    return acc


def extract_lwe_ntru(acc, q):
    """NTRU accumulator → LWE sample under the key ``f`` (b = 0).

    ``phase = (acc·f)(0) = Σ_j a_j f_j`` with ``a = (acc_0, −acc_{N−1},
    …, −acc_1)`` — the negacyclic constant-coefficient arrangement
    (mirrors ``Rlwe::extract_lwe``, rlwe/coeff.rs:194-230, with the mask
    being the ciphertext itself).
    """
    head = acc[..., :1]
    tail = neg32(jnp.flip(acc[..., 1:], axis=-1), q)
    return jnp.concatenate([head, tail], axis=-1)


def lwe_phase_q(a, f, m: BarrettModulus32):
    """``Σ a_j f_j mod q`` — LWE phase under the NTRU key coefficients."""
    return dot32(a, jnp.broadcast_to(f, a.shape), m)


def ntru_test_polynomial(n: int, q: int, delta: int) -> jnp.ndarray:
    """Constant sign-test vector ``Δ·Σ X^i`` (gate-bootstrap test poly)."""
    return jnp.full((n,), np.uint32(delta % q), dtype=_U32)


# ---------------------------------------------------------------------------
# Modulus switch (q -> 2N) and LWE key switch (f -> s), all mod q
# ---------------------------------------------------------------------------


def _barrett_quotient_wide32(lo, hi, m: BarrettModulus32):
    """``floor((hi·2^32 + lo) / q)`` up to −1 (paired with a single
    compare-correct) — the quotient side of the reference's wide-reduce
    diagram (barrett/mod.rs:99-132)."""
    from ..numeric.limb import mul_wide_u32, mulhi_u32

    ah = mulhi_u32(lo, m.ratio_lo)
    b_lo, b_hi = mul_wide_u32(lo, m.ratio_hi)
    b_lo2 = b_lo + ah
    b_hi = b_hi + (b_lo2 < b_lo).astype(_U32)
    c_lo, c_hi = mul_wide_u32(hi, m.ratio_lo)
    d = hi * m.ratio_hi
    s = b_lo2 + c_lo
    carry = (s < b_lo2).astype(_U32)
    return d + b_hi + c_hi + carry


def modulus_switch_q(lwe_q, ctx: NtruContext, log_2n: int):
    """Round-to-nearest rescale ``Z_q -> Z_{2N}``: ``round(x·2N/q) mod 2N``.

    Exact integer arithmetic: wide product, +q/2, Barrett quotient with one
    compare-correct (the quotient analogue of ``lazy_reduce_wide``).
    """
    from ..numeric.limb import mul_wide_u32

    two_n = jnp.uint32(1 << log_2n)
    lo, hi = mul_wide_u32(jnp.asarray(lwe_q, _U32), two_n)
    half = jnp.uint32(ctx.q_int // 2)
    lo2 = lo + half
    hi = hi + (lo2 < lo).astype(_U32)
    q_hat = _barrett_quotient_wide32(lo2, hi, ctx.m)
    r = lo2 - q_hat * ctx.m.value  # [0, 2q)
    q_hat = q_hat + (r >= ctx.m.value).astype(_U32)
    return (q_hat & ((1 << log_2n) - 1)).astype(jnp.int32)


def make_ntru_keyswitch_key(
    key, ctx: NtruContext, sk: NtruSecret, secret_out, ks_basis, gaussian
):
    """KSK ``(N, level, n_out + 1)`` mod q: ``KSK[i,l] = LWE_s(f_i·B^l·2^drop)``.

    The mod-q mirror of the torus key switch (`lattice/keyswitch.py`);
    ``secret_out``: (n_out,) binary.
    """
    from ..distr.sampling import sample_uniform
    from ..modular.modops import sum_mod32

    n_in = ctx.n
    n_out = int(secret_out.shape[0])
    level = ks_basis.decompose_length
    ka, ke = jax.random.split(key)
    a = sample_uniform(ka, (n_in, level, n_out), ctx.q_int)
    e = gaussian.sample_mod(ke, (n_in, level), ctx.q_int)
    scal = jnp.asarray(
        np.array([s % ctx.q_int for s in ks_basis.scalars], dtype=np.uint32)
    )
    msg = reduce_once32(
        lazy_mul32(sk.f[:, None], scal[None, :], ctx.m), ctx.m.value
    )  # (n_in, level)
    asum = sum_mod32(a * secret_out[None, None, :], ctx.m, axis=-1)
    b = add32(add32(asum, msg, ctx.m.value), e, ctx.m.value)
    return jnp.concatenate([a, b[..., None]], axis=-1)


@functools.partial(jax.jit, static_argnums=(0, 3))
def ntru_key_switch(ctx: NtruContext, lwe, ksk, ks_basis):
    """``(..., N + 1)`` LWE under ``f`` -> ``(..., n_out + 1)`` under ``s``.

    ``out = (0…0, b) − Σ_{i,l} digit_l(a_i) · KSK[i,l]`` mod q.
    """
    from ..modular.modops import sum_mod32

    n_in, level, n_out1 = ksk.shape
    a = lwe[..., :n_in]
    b = lwe[..., n_in]
    digits = ks_basis.decompose(a)  # (level, ..., n_in) mod q
    digits = jnp.moveaxis(digits, 0, -1)  # (..., n_in, level)
    m_x = jax.tree.map(lambda x: x.reshape((1,) * 3), ctx.m)
    prod = reduce_once32(
        lazy_mul32(digits[..., None], ksk, m_x), ctx.m.value
    )  # (..., n_in, level, n_out+1)
    acc = sum_mod32(prod, ctx.m, axis=(-3, -2))
    out = jnp.zeros(lwe.shape[:-1] + (n_out1,), dtype=_U32)
    out = out.at[..., -1].set(b)
    return sub32(out, acc, ctx.m.value)
