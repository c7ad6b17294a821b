"""TFHE blind-rotation bootstrapping.

The reference stops at the external product + LWE extraction — "callers are
expected to compose blind rotation etc." (SURVEY.md §1).  This module is
that composition:

1. **modulus switch**: LWE coefficients mod 2^32 -> rounded mod 2N,
2. **blind rotate**: ``acc <- CMux(BSK_i, acc * X^{a_i}, acc)`` over the
   LWE mask — a ``lax.scan`` over the bootstrap key with the exact
   CRT-NTT external product as the body (compiled once, runs n_lwe times),
3. **sample extract**: RLWE coefficient 0 -> LWE (rlwe/coeff.rs:194-230).

CMux uses the linearity of the external product:
``CMux(C, d1, d0) = d0 + (d1 - d0) ⊡ C`` — one external product per step.
Batched ciphertexts ride along leading axes; the scan is shared.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..decompose.primitive import ApproxSignedBasis32
from ..lattice.tfhe import external_product
from ..transforms.torus import TorusConvolver32

_U32 = jnp.uint32


def modulus_switch(lwe, log_2n: int):
    """Rounds torus-2^32 LWE coefficients to ``Z_{2N}`` (round-to-nearest).

    ``round(x * 2N / 2^32) mod 2N`` — the standard pre-rotation switch.
    """
    shift = 32 - log_2n
    half = _U32(1 << (shift - 1))
    return ((lwe + half) >> shift).astype(jnp.int32) & ((1 << log_2n) - 1)


def _rotate_glwe(glwe, degree, n: int):
    """``glwe * X^degree`` mod ``X^N + 1`` over the 2^32 torus (wrapping).

    ``degree`` broadcasts against ``glwe.shape[:-1]`` (scalar, or per-batch
    with trailing 1-axes added by the caller).

    Implemented as a chain of *conditional static negacyclic shifts*, one
    per bit of ``degree mod 2N`` — static slices + selects instead of a
    data-dependent gather.  ``X^N = -1`` makes the top bit a plain
    negation.
    """
    d = jnp.asarray(degree, jnp.int32) % (2 * n)
    v = glwe
    for b in range(n.bit_length()):  # bits 0 .. log2(n)
        k = 1 << b
        if k == n:
            rolled = jnp.zeros_like(v) - v  # X^n = -1
        else:
            head = jnp.zeros_like(v[..., n - k :]) - v[..., n - k :]
            rolled = jnp.concatenate([head, v[..., : n - k]], axis=-1)
        take = ((d >> b) & 1)[..., None] == 1
        v = jnp.where(take, rolled, v)
    return v


@functools.partial(jax.jit, static_argnums=(0, 1))
def blind_rotate(
    conv: TorusConvolver32,
    basis: ApproxSignedBasis32,
    bsk_ntt,  # (n_lwe, kp, k+1, L, k+1, N) — GGSW(s_i) in NTT residues
    lwe_switched,  # (..., n_lwe + 1) int32 mod 2N
    test_poly,  # (N,) torus u32
):
    """Returns the rotated accumulator GLWE ``(..., k+1, N)``.

    ``acc = (0, v * X^{-b})``; for each mask element
    ``acc <- acc + (acc * X^{a_i} - acc) ⊡ BSK_i``.
    """
    n_lwe = bsk_ntt.shape[0]
    kp, k1, level, k1b, n = bsk_ntt.shape[1:]
    batch = lwe_switched.shape[:-1]

    b = lwe_switched[..., n_lwe]
    v_rot = _rotate_glwe(test_poly, -b, n)
    acc = jnp.zeros(batch + (k1, n), dtype=_U32)
    acc = acc.at[..., -1, :].set(v_rot)

    def body(acc, x):
        a_i, bsk_i = x
        deg = a_i[..., None] if batch else a_i  # broadcast over k+1
        rotated = _rotate_glwe(acc, deg, n)
        delta = external_product(conv, basis, rotated - acc, bsk_i)
        return acc + delta, None

    a_t = jnp.moveaxis(lwe_switched[..., :n_lwe], -1, 0)  # (n_lwe, ...)
    acc, _ = jax.lax.scan(body, acc, (a_t, bsk_ntt))
    return acc


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def make_bootstrap_key(key, lwe_secret, glwe_secret, basis, gaussian, conv):
    """BSK_i = GGSW(s_i) under the GLWE secret, stacked ``(n_lwe, ...)``.

    ``lwe_secret``: (n_lwe,) bits as uint32.  Jitted end-to-end: the
    n_lwe-fold vmapped GGSW encryption is one compiled program instead of
    thousands of eager dispatches.
    """
    from ..lattice.tfhe import ggsw_encrypt_torus

    n_lwe = lwe_secret.shape[0]
    keys = jax.random.split(key, n_lwe)
    ggsw_all = jax.vmap(
        lambda kk, s_i: ggsw_encrypt_torus(kk, s_i, glwe_secret, basis, gaussian, conv)
    )(keys, lwe_secret)  # (n_lwe, k+1, L, k+1, N)
    # forward-transform all rows at once; conv.forward maps (..., N) ->
    # (kp, ..., N), so move the prime axis behind the BSK index.
    f = conv.forward(ggsw_all)
    return jnp.moveaxis(f, 0, 1)


def test_polynomial(n: int, message_bits: int) -> np.ndarray:
    """The negacyclic sign test vector encoding ``f(x) = msb bucket``.

    The canonical gate-bootstrap test poly: constant ``1/8`` scaled into the
    top bits; callers wanting programmable bootstrap pass their own table.
    """
    delta = 1 << (32 - message_bits - 1)
    return np.full(n, delta, dtype=np.uint32)


def bootstrap(conv, basis, bsk_ntt, lwe_ct, test_poly, log_n: int):
    """Full pipeline: modulus switch -> blind rotate -> extract LWE."""
    from ..lattice.rlwe import extract_lwe_torus32

    switched = modulus_switch(lwe_ct, log_n + 1)
    acc = blind_rotate(conv, basis, bsk_ntt, switched, test_poly)
    # extract from the (body, mask...) GLWE: treat k=1 GLWE as RLWE
    rlwe = acc  # (..., k+1, N) with k=1: [a, b]
    return extract_lwe_torus32(rlwe)


def lut_test_polynomial(values, log_n: int, message_bits: int):
    """Programmable-bootstrap test vector for an arbitrary lookup table.

    ``values``: (2^message_bits,) torus-encoded outputs ``f(m)``.  Encodes
    the negacyclic step function so that blind rotation by a phase in
    message bucket ``m`` lands ``f(m)`` on coefficient 0 (standard PBS
    encoding; buckets span the lower torus half, the upper half returns
    the negated table — callers usually reserve one message bit for sign
    or use the padding-bit convention).
    """
    import numpy as np

    n = 1 << log_n
    values = np.asarray(values, dtype=np.uint32)
    m_count = values.shape[0]
    reps = n // m_count
    if reps * m_count != n:
        raise ValueError("2^message_bits must divide N")
    # bucket m covers rotations [m*reps - reps/2, m*reps + reps/2): shift
    # by half a bucket so rounding is centered.
    tp = np.repeat(values, reps)
    tp = np.roll(tp, -(reps // 2))
    tp[-(reps // 2):] = (-tp[-(reps // 2):].astype(np.int64) % (1 << 32)).astype(np.uint32)
    return jnp.asarray(tp)
