"""GLWE samples over the 2^32 torus: ``(..., k+1, N)`` = ``[a_1..a_k; b]``.

Reference: ``crates/primus_lattice/src/glwe/*.rs``.  The torus variant uses
wrapping u32 arithmetic (NativeModulus) as in TFHE; negacyclic products go
through the exact CRT-NTT convolver (:mod:`..transforms.torus`) instead of
the reference's f64 FFT — bit-deterministic on every backend.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..distr.sampling import DiscreteGaussian
from ..transforms.torus import TorusConvolver32

_U32 = jnp.uint32


@functools.partial(jax.jit, static_argnums=(2, 3))
def generate_random_zero_sample_torus(
    key,
    secret,  # (k, N) torus secret key polys (binary/ternary wrapped)
    gaussian: DiscreteGaussian,
    conv: TorusConvolver32,
):
    """GLWE encryption of zero: ``(a_1..a_k, sum a_i s_i + e)``."""
    k, n = secret.shape
    ka, ke = jax.random.split(key)
    a = jax.random.bits(ka, (k, n), dtype=jnp.uint32)
    fa = conv.forward(a)  # (kp, k, n)
    fs = conv.forward(secret)
    prod = conv.mul(fa, fs, extra=2)
    # exact sum over k of negacyclic products, still in residue NTT domain
    from ..modular.modops import sum_mod32

    m = conv._m(1)
    acc = sum_mod32(jnp.moveaxis(prod, 1, -1), m, axis=-1)  # (kp, n)
    b = conv.recombine(conv.inverse(acc)) + gaussian.sample_torus32(ke, (n,))
    return jnp.concatenate([a, b[None]], axis=-2)


@functools.partial(jax.jit, static_argnums=(3, 4))
def encrypt_torus(key, message, secret, gaussian, conv):
    """GLWE encryption of a torus message polynomial ``(N,)``."""
    ct = generate_random_zero_sample_torus(key, secret, gaussian, conv)
    return ct.at[..., -1, :].add(message)


@functools.partial(jax.jit, static_argnums=2)
def phase_torus(glwe, secret, conv: TorusConvolver32):
    """``b - sum a_i s_i`` mod 2^32 — exact decryption phase."""
    a = glwe[..., :-1, :]
    b = glwe[..., -1, :]
    fa = conv.forward(a)
    fs = conv.forward(secret)
    extra = fa.ndim - 1
    prod = conv.mul(fa, fs, extra)
    from ..modular.modops import sum_mod32

    m = conv._m(prod.ndim - 2)  # output drops the summed k axis
    acc = sum_mod32(jnp.moveaxis(prod, -2, -1), m, axis=-1)
    return b - conv.recombine(conv.inverse(acc))
