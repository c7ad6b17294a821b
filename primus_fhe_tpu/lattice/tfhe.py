"""TFHE external product — exact CRT-NTT backend.

Reference: ``crates/primus_lattice/src/tfhe/external_product.rs:36-93`` and
the coeff↔Fourier conversions (``src/tfhe/convert.rs:32-143``).  Structure
is identical — signed gadget decomposition, per-digit forward transform,
multiply-accumulate against the GGSW rows, one inverse transform — but the
transform is the exact integer CRT-NTT (:class:`TorusConvolver32`), so the
result carries **zero** transform noise (the f64 FFT path of the reference
rounds; this path does not).

Shapes (u32 torus):
- ``glwe``:     ``(B..., k+1, N)``
- ``key``:      coeff ``(k+1, L, k+1, N)``; NTT form ``(kp, k+1, L, k+1, N)``
- ``output``:   ``(B..., k+1, N)``
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian
from ..modular.modops import (
    barrett_lazy_reduce32 as modops_barrett_lazy_reduce32,
    lazy_mul32,
    reduce_once32,
)
from ..transforms.torus import TorusConvolver32

_U32 = jnp.uint32


def external_product_bound_bits(n: int, level: int, k: int, log_basis: int) -> int:
    """Proven bound on the centered convolution accumulator magnitude.

    ``|acc| <= n * level * (k+1) * (B/2) * 2^31`` — every digit is centered
    in ``[-B/2, B/2]`` and every key coefficient in ``[-2^31, 2^31)``.
    """
    import math

    return 31 + (log_basis - 1) + math.ceil(math.log2(n * level * (k + 1))) + 1


def make_convolver(n_log: int, level: int, k: int, log_basis: int) -> TorusConvolver32:
    return TorusConvolver32(
        n_log, external_product_bound_bits(1 << n_log, level, k, log_basis)
    )


def ggsw_to_ntt(conv: TorusConvolver32, ggsw_coeff):
    """Coeff-domain GGSW ``(k+1, L, k+1, N)`` -> NTT residues (convert.rs)."""
    return conv.forward(ggsw_coeff)


@functools.partial(jax.jit, static_argnums=(0, 1))
def external_product(
    conv: TorusConvolver32,
    basis: ApproxSignedBasis32,
    glwe,
    key_ntt,
):
    """``output = glwe ⊡ key`` (external_product.rs:36-93), exact.

    ``glwe``: ``(B..., k+1, N)`` torus u32; ``key_ntt``: as from
    :func:`ggsw_to_ntt`.  Returns ``(B..., k+1, N)``.
    """
    kp = conv.count
    k1, level, k1b, n = key_ntt.shape[1:]
    assert k1 == k1b
    batch = glwe.shape[:-2]

    # 1. signed decomposition: (L, B..., k+1, N) -> (B..., k+1, L, N)
    digits = basis.decompose(glwe)
    digits = jnp.moveaxis(digits, 0, -2)

    # 2. forward transform all digits at once: (kp, B..., k+1, L, N)
    f = conv.forward(digits)

    # 3-4. MAC + inverse + recombine.
    return _external_product_tail(conv, f, key_ntt, batch)


def _external_product_tail(conv, f, key_ntt, batch):
    """MAC + inverse NTT + CRT recombine.

    ``f``: ``(kp, B..., k1, L, N)`` NTT-domain digit residues (canonical or
    lazy ``[0, 4p)`` — the wide Barrett bound ``4p^2 < p*2^32`` holds either
    way).  Unrolled (component, level) accumulation with wrap-exact raw u32
    sums: canonical terms are < p < 2^30, so up to 4 sum exactly in uint32
    before a single Barrett pass — far cheaper than generic split-limb
    reduction and free of transpose relayouts.
    """
    kp = conv.count
    k1, level, k1b, n = key_ntt.shape[1:]
    key_b = key_ntt.reshape((kp,) + (1,) * len(batch) + (k1, level, k1b, n))
    # t has shape (kp, B..., j, N): rank 1 + len(batch) + 2, so the modulus
    # record broadcasts with len(batch) + 2 trailing singleton axes.
    m_x = conv._m(len(batch) + 2)
    assert max(conv.primes) < 1 << 30
    cap = 4
    acc = None
    pending = 0
    for r in range(k1):
        for l in range(level):
            t = lazy_mul32(
                f[..., r, l, None, :], key_b[..., r, l, :, :], m_x
            )
            t = reduce_once32(t, m_x.value)  # canonical [0, p)
            if acc is None:
                acc = t
                pending = 1
            else:
                if pending == cap:
                    acc = reduce_once32(
                        modops_barrett_lazy_reduce32(acc, m_x), m_x.value
                    )
                    pending = 1
                acc = acc + t  # raw u32, exact while pending < cap
                pending += 1
    acc = reduce_once32(modops_barrett_lazy_reduce32(acc, m_x), m_x.value)
    return conv.recombine(conv.inverse(acc))


# ---------------------------------------------------------------------------
# GGSW encryption (test/bootstrap-key construction helper)
# ---------------------------------------------------------------------------


def ggsw_encrypt_torus(
    key,
    mu,  # scalar int (message, e.g. 0/1) or (N,) torus poly
    secret,  # (k, N)
    basis: ApproxSignedBasis32,
    gaussian: DiscreteGaussian,
    conv: TorusConvolver32,
):
    """GGSW(mu): row r level l = GLWE(0) + mu * B^l * 2^drop at component r.

    The standard TFHE gadget layout aligned with the external-product row
    order (a_1..a_k, b) — see tfhe/external_product.rs:64.
    """
    from .glwe import generate_random_zero_sample_torus

    k, n = secret.shape
    level = basis.decompose_length
    keys = jax.random.split(key, (k + 1) * level)
    mu_arr = jnp.asarray(mu, dtype=_U32)
    if mu_arr.ndim == 0:
        # scalar message = the constant polynomial mu (coefficient 0 only).
        mu_arr = jnp.zeros(n, dtype=_U32).at[0].set(mu_arr)

    # All (k+1)*level zero samples in one vmapped program.
    zs = jax.vmap(
        lambda kk: generate_random_zero_sample_torus(kk, secret, gaussian, conv)
    )(keys).reshape(k + 1, level, k + 1, n)

    # Gadget injection: row r, level l adds mu * B^l * 2^drop at component r.
    scal = jnp.asarray(
        np.array([s & 0xFFFFFFFF for s in basis.scalars], dtype=np.uint32)
    )  # (level,)
    contrib = mu_arr[None, :] * scal[:, None]  # (level, n)
    eye = jnp.eye(k + 1, dtype=_U32)  # (row r, component j)
    return zs + eye[:, None, :, None] * contrib[None, :, None, :]
