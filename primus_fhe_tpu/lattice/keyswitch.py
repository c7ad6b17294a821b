"""LWE key switching via gadget decomposition.

The reference ships the key-switching-*shaped* gadget product (SURVEY.md
§7 step 5) without a scheme-level driver; this module provides the standard
LWE->LWE switch the bootstrap pipeline needs after sample extraction:

    KSK[i, l] = LWE_{s'}( s_i * B^l * 2^drop )      (torus 2^32)
    switch(c) : out = (0, b) - sum_{i,l} d_l(a_i) * KSK[i, l]

where ``d_l`` is the signed gadget decomposition of each mask coefficient.
All (i, l) contributions are one tensor contraction.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..decompose.primitive import ApproxSignedBasis32
from ..distr.sampling import DiscreteGaussian

_U32 = jnp.uint32


def make_keyswitch_key(key, secret_in, secret_out, basis: ApproxSignedBasis32, gaussian: DiscreteGaussian):
    """KSK ``(n_in, level, n_out + 1)`` torus u32.

    ``secret_in``: (n_in,) the extracted-domain secret (e.g. flattened GLWE
    key); ``secret_out``: (n_out,) the target LWE secret.
    """
    n_in = secret_in.shape[0]
    n_out = secret_out.shape[0]
    level = basis.decompose_length
    ka, ke = jax.random.split(key)
    a = jax.random.bits(ka, (n_in, level, n_out), dtype=jnp.uint32)
    e = gaussian.sample_torus32(ke, (n_in, level))
    scal = jnp.asarray(
        [s & 0xFFFFFFFF for s in basis.scalars], dtype=_U32
    )  # (level,)
    msg = secret_in[:, None] * scal[None, :]  # (n_in, level)
    b = jnp.sum(a * secret_out[None, None, :], axis=-1, dtype=_U32) + msg + e
    return jnp.concatenate([a, b[..., None]], axis=-1)


@functools.partial(jax.jit, static_argnums=(2,))
def key_switch(lwe, ksk, basis: ApproxSignedBasis32):
    """Switches ``(..., n_in + 1)`` LWE to ``(..., n_out + 1)`` under KSK."""
    n_in, level, n_out1 = ksk.shape
    a = lwe[..., :n_in]
    b = lwe[..., n_in]
    digits = basis.decompose(a)  # (level, ..., n_in) torus-signed u32
    digits = jnp.moveaxis(digits, 0, -1)  # (..., n_in, level)
    # out = sum_{i,l} d[i,l] * ksk[i,l,:]  (wrapping torus arithmetic) as a
    # broadcast-multiply-reduce: XLA fuses the product into the reduction,
    # so the (..., n_in, level, n_out+1) product is never materialised.
    acc = jnp.sum(
        digits[..., :, :, None] * ksk[None] if digits.ndim > 2 else digits[..., None] * ksk,
        axis=(-3, -2),
        dtype=_U32,
    )
    out = jnp.zeros(lwe.shape[:-1] + (n_out1,), dtype=_U32)
    out = out.at[..., -1].set(b)
    return out - acc
