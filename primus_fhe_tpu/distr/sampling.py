"""Device-side FHE noise samplers.

Reference: ``crates/primus_distr/src/lib.rs:3-29`` — ``BinaryDistr``,
``SparseTernaryDistr`` ({0,±1} with p = 1/2, 1/4, 1/4), and
``DiscreteGaussian`` choosing a **CDT** inverse-transform sampler for small
sigma or Ziggurat otherwise (``src/discrete_gaussian/mod.rs:25-87``), plus
CRT-replicated sampling (``src/common.rs:129-350``) that writes the same
logical value into every modulus slot.

Device design (SURVEY.md §7 hard part 6): the CDT lookup vectorizes as a
``searchsorted`` gather and is exact to 64-bit CDF resolution, so it is the
on-device sampler for the small-sigma regime (σ ≲ 100 — every key/GLWE
noise the shipped profiles use); Ziggurat's data-dependent rejection loop
would defeat XLA and stays host-side (numpy) only as a cross-check in
tests.  Above ``_CDT_SIGMA_MAX`` (the estimator-driven LWE noise widths,
σ ~ 2^18 — ``params.py`` BOOLEAN_128) the CDT table would need ~20σ
entries with an O(20σ)-per-sample compare-sum, so the sampler switches to
a **rounded continuous Gaussian** (``round(sigma * N(0,1))``): at those
widths the statistical distance to the true discrete Gaussian is far
below the 2^-64 table resolution the CDT path itself tolerates.

Randomness comes from ``jax.random`` keys — counter-based, reproducible,
and splittable across shards, unlike the reference's sequential ``StdRng``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..numeric.limb import U64

_U32 = jnp.uint32


def _bits32(key, shape):
    return jax.random.bits(key, shape, dtype=jnp.uint32)


def sample_binary(key, shape, q=None):
    """Uniform bits in {0, 1} as uint32 (``BinaryDistr``, binary.rs:8)."""
    return _bits32(key, shape) & 1


def sample_ternary(key, shape, q):
    """{0, ±1} with p = 1/2, 1/4, 1/4; -1 is ``q - 1`` (ternary.rs:10).

    ``q`` may be an int (uint32 path) or a python int < 2^64 for U64 use.
    """
    b = _bits32(key, shape) & 3
    q = jnp.asarray(q, dtype=_U32)
    zero = jnp.zeros(shape, dtype=_U32)
    return jnp.where(b < 2, zero, jnp.where(b == 2, jnp.ones(shape, _U32), q - 1))


def sample_uniform(key, shape, q: int):
    """Uniform in ``[0, q)`` for ``q < 2^31`` via 64-bit multiply-shift.

    ``floor(u64 * q / 2^64)`` from two 32-bit words: bias < 2^-33, the
    standard unbiased-to-negligible lattice-sampling reduction.
    """
    from ..numeric.limb import u64_mul_hi

    k1, k2 = jax.random.split(key)
    lo = _bits32(k1, shape)
    hi = _bits32(k2, shape)
    u = U64(lo, hi)
    qq = U64(jnp.full(shape, q & 0xFFFFFFFF, _U32), jnp.full(shape, q >> 32, _U32))
    return u64_mul_hi(u, qq).lo  # q < 2^31 -> high word < q fits u32


def sample_uniform_u64(key, shape, q: int) -> U64:
    """Uniform in ``[0, q)`` for ``q < 2^62`` via 128-bit multiply-shift."""
    from ..numeric.limb import u64_mul_wide

    k1, k2 = jax.random.split(key)
    u = U64(_bits32(k1, shape), _bits32(k2, shape))
    qq = U64(
        jnp.full(shape, q & 0xFFFFFFFF, _U32),
        jnp.full(shape, (q >> 32) & 0xFFFFFFFF, _U32),
    )
    return u64_mul_wide(u, qq)[1]


class DiscreteGaussian:
    """Discrete Gaussian over Z via a cumulative-distribution table.

    Host-precomputes ``P[|X| <= t]`` to 64-bit fixed point out to
    ``tail_cut`` sigmas (default 10 — mass below 2^-70 beyond it), then
    samples by inverting a 64-bit uniform against the table and applying a
    random sign.  Matches the reference CDT sampler's construction
    (``src/discrete_gaussian/cdt.rs``) with table resolution 2^-64.
    """

    _CDT_SIGMA_MAX = 256.0  # above this, rounded-continuous sampling

    def __init__(self, sigma: float, mean: float = 0.0, tail_cut: float = 10.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        self.sigma = float(sigma)
        self.mean = float(mean)
        if mean != 0.0:
            raise NotImplementedError("nonzero mean not supported yet")
        if sigma > self._CDT_SIGMA_MAX:
            # rounded continuous Gaussian (see module docstring); 10-sigma
            # tails of every shipped profile stay far inside int32
            if sigma * tail_cut >= 2.0**31:
                raise ValueError("sigma too large for int32 samples")
            self.offsets = None
            return
        max_t = int(np.ceil(sigma * tail_cut)) + 1
        ts = np.arange(-max_t, max_t + 1)
        # Exact-enough weights in float128-ish: use exp in float64 and
        # normalize; table resolution is what bounds statistical distance.
        w = np.exp(-(ts.astype(np.float64) ** 2) / (2 * self.sigma**2))
        w /= w.sum()
        cdf = np.cumsum(w)
        # 64-bit fixed-point thresholds, split into two u32 words.
        fixed = np.minimum((cdf * 2.0**64).astype(object), (1 << 64) - 1)
        fixed = np.array([int(v) for v in fixed], dtype=np.uint64)
        self.offsets = jnp.asarray(ts.astype(np.int32))
        self.cdf_hi = jnp.asarray((fixed >> np.uint64(32)).astype(np.uint32))
        self.cdf_lo = jnp.asarray((fixed & np.uint64(0xFFFFFFFF)).astype(np.uint32))

    def sample_signed(self, key, shape):
        """Signed int32 samples."""
        if self.offsets is None:  # large-sigma rounded-continuous path
            g = jax.random.normal(key, shape, dtype=jnp.float32)
            return jnp.round(g * np.float32(self.sigma)).astype(jnp.int32)
        k1, k2 = jax.random.split(key)
        u_hi = _bits32(k1, shape)
        u_lo = _bits32(k2, shape)
        # searchsorted on the 64-bit threshold (hi major, lo minor):
        # index = #(cdf < u) computed via broadcasting compare-sum over the
        # (small) table axis.
        c_hi = self.cdf_hi
        c_lo = self.cdf_lo
        lt = (c_hi[..., None, :] < u_hi[..., None]) | (
            (c_hi[..., None, :] == u_hi[..., None]) & (c_lo[..., None, :] < u_lo[..., None])
        )
        idx = jnp.sum(lt, axis=-1).astype(jnp.int32)
        idx = jnp.minimum(idx, self.offsets.shape[0] - 1)
        return self.offsets[idx].reshape(shape)

    def sample_mod(self, key, shape, q: int):
        """Samples wrapped into ``[0, q)`` as uint32 (``q < 2^31``)."""
        s = self.sample_signed(key, shape)
        return jnp.where(s < 0, _U32(q) + s.astype(_U32), s.astype(_U32))

    def sample_mod_u64(self, key, shape, q: int) -> U64:
        """Samples wrapped into ``[0, q)`` as U64 pairs."""
        from ..numeric.limb import u64_add, u64_full, u64_select

        s = self.sample_signed(key, shape)
        qq = u64_full(shape, q)
        signed_ext = U64(s.astype(_U32), (s >> 31).astype(_U32))  # sign-extend
        wrapped = u64_add(qq, signed_ext)  # q + s (s < 0)
        pos = U64(s.astype(_U32), jnp.zeros(shape, _U32))
        return u64_select(s < 0, wrapped, pos)

    def sample_torus32(self, key, shape):
        """Samples wrapped mod 2^32 (TFHE torus)."""
        s = self.sample_signed(key, shape)
        return s.astype(_U32)


# ---------------------------------------------------------------------------
# CRT-replicated sampling (src/common.rs:129-350): one logical sample
# written consistently into every modulus slot of shape (k, ...).
# ---------------------------------------------------------------------------


def _replicate(values, moduli, signed_floor=None):
    return jnp.broadcast_to(values[None], (moduli.shape[0],) + values.shape)


def sample_crt_binary(key, shape, moduli):
    """Binary samples replicated along a leading (k,) modulus axis."""
    v = sample_binary(key, shape)
    return jnp.broadcast_to(v[None], (moduli.shape[0],) + shape)


def sample_crt_ternary(key, shape, moduli):
    """Ternary samples per-modulus: -1 maps to ``q_i - 1`` in each slot."""
    b = _bits32(key, shape) & 3
    k = moduli.shape[0]
    q = moduli.reshape((k,) + (1,) * len(shape)).astype(_U32)
    zero = jnp.zeros((k,) + shape, dtype=_U32)
    one = jnp.ones((k,) + shape, dtype=_U32)
    bb = jnp.broadcast_to(b[None], (k,) + shape)
    return jnp.where(bb < 2, zero, jnp.where(bb == 2, one, q - 1))


def sample_crt_gaussian(key, shape, moduli, gaussian: DiscreteGaussian):
    """Gaussian samples per-modulus: negatives map to ``q_i + s``."""
    s = gaussian.sample_signed(key, shape)
    k = moduli.shape[0]
    q = moduli.reshape((k,) + (1,) * len(shape)).astype(_U32)
    sb = jnp.broadcast_to(s[None], (k,) + shape)
    return jnp.where(sb < 0, q + sb.astype(_U32), sb.astype(_U32))
