"""Exact torus negacyclic convolution via CRT-NTT.

The exact replacement for the reference's f64 torus FFT
(``crates/primus_fft/src/complex64/table.rs``): the f64 path loses
precision above 2^53 (torus.rs:20-58).  Instead,
torus (mod ``2^32`` / ``2^64``) negacyclic products are computed **exactly**:

1. centered lift of torus values into residues mod a few 30-bit NTT primes,
2. per-prime negacyclic NTTs (:mod:`.dcrt` — the hot path, fully batched),
3. pointwise multiply-accumulate in the NTT domain,
4. inverse NTTs and CRT recombination back to the torus, with the CRT
   quotient ``alpha`` recovered by *integer* fixed-point arithmetic — no
   floats anywhere, so results are bit-deterministic on every backend.

Correctness condition: every intermediate centered convolution value must
satisfy ``|V| < P/8`` where ``P`` is the prime product; the constructor
takes ``bound_bits`` (a proven bound on ``log2 |V|``) and picks enough
primes.  For the TFHE external product the bound is
``log2(n * level * (k+1) * (B/2)) + 31`` (digits × torus key values).

The ``FourierPolynomial`` complex-FMA hot path of the reference
(``primus_poly/src/fourier/mul.rs:34-49``) becomes lazy modular
multiply-accumulates in the NTT domain here (:meth:`TorusConvolver32.mul` /
``add_mul``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..modular.factor import factor_mul32
from ..modular.modulus import barrett32
from ..modular.modops import (
    add32,
    barrett_lazy_reduce32,
    lazy_mul32,
    mul32,
    reduce_once32,
    sub32,
)
from ..modular.factor import shoup32
from ..numeric.limb import U64, to_u64_pair
from ..utils.gcd import mod_inv
from ..utils.primes import next_ntt_prime
from .dcrt import build_dcrt_plan32, dcrt_forward32, dcrt_inverse32

_U32 = jnp.uint32


class TorusConvolver32:
    """Exact negacyclic convolver for the 2^32 torus (u32 values)."""

    def __init__(self, log_n: int, bound_bits: int = 56):
        self.log_n = log_n
        self.n = 1 << log_n
        # Pick 30-bit NTT primes until the product covers bound + 3 margin.
        primes: list[int] = []
        below = None
        prod = 1
        while prod.bit_length() <= bound_bits + 3:
            p = next_ntt_prime(30, log_n, below)
            primes.append(p)
            below = p
            prod *= p
        self.primes = primes
        self.product = prod
        self.count = k = len(primes)

        self.plan = build_dcrt_plan32(log_n, primes)
        self.modulus = barrett32(np.array(primes, dtype=np.uint64))  # (k,)

        # centered-lift correction: 2^32 mod p_i
        self.wrap_c = jnp.asarray(
            np.array([(1 << 32) % p for p in primes], dtype=np.uint32)
        )
        # CRT recombination tables
        punctured = [prod // p for p in primes]
        self.inv_punctured = shoup32(
            np.array([mod_inv(pp % p, p) for pp, p in zip(punctured, primes)], dtype=np.uint64),
            np.array(primes, dtype=np.uint64),
        )  # (k,)
        self.punctured_mod_t = jnp.asarray(
            np.array([pp % (1 << 32) for pp in punctured], dtype=np.uint32)
        )
        self.product_mod_t = jnp.uint32(prod % (1 << 32))
        # alpha fixed-point: floor(2^64 / p_i) as U64
        self.alpha_fix = to_u64_pair(
            np.array([(1 << 64) // p for p in primes], dtype=np.uint64)
        )

    # -- broadcast helpers --------------------------------------------------

    def _m(self, extra: int):
        """Barrett record broadcast to (k, 1...)."""
        shape = (self.count,) + (1,) * extra
        return jax.tree.map(lambda x: x.reshape(shape), self.modulus)

    # -- pipeline stages ----------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0)
    def lift(self, x):
        """Centered lift: torus u32 ``(..., n)`` -> residues ``(k, ..., n)``.

        ``value = x - 2^32 * [x >= 2^31]``; residue = ``x mod p`` minus the
        wrap constant when negative.
        """
        k = self.count
        nd = x.ndim
        m = self._m(nd)
        xb = x[None]
        r = reduce_once32(barrett_lazy_reduce32(xb, m), m.value)
        c = self.wrap_c.reshape((k,) + (1,) * nd)
        neg = (xb >> 31) != 0
        return jnp.where(neg, sub32(r, c, m.value), r)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def forward(self, x, out_factor: int = 1):
        """Torus poly ``(..., n)`` -> NTT-domain residues ``(k, ..., n)``."""
        lifted = self.lift(x)
        return dcrt_forward32(self.plan, lifted, out_factor)

    def mul(self, fa, fb, extra: int):
        """Pointwise canonical product of NTT-domain residue tensors."""
        return mul32(fa, fb, self._m(extra))

    def add_mul_lazy(self, acc, fa, fb, extra: int):
        """``acc + fa * fb`` with lazy products, canonicalized.

        The accumulate analogue of ``FourierPolynomial::add_mul_assign`` —
        exact (no drift), one reduce per term.
        """
        t = lazy_mul32(fa, fb, self._m(extra))
        m = self._m(extra)
        return reduce_once32(add32(acc, reduce_once32(t, m.value), m.value), m.value)

    @functools.partial(jax.jit, static_argnums=0)
    def inverse(self, res):
        """NTT-domain residues -> coefficient-domain residues, canonical."""
        return dcrt_inverse32(self.plan, res)

    @functools.partial(jax.jit, static_argnums=0)
    def recombine(self, res):
        """Coefficient residues ``(k, ..., n)`` -> torus u32 ``(..., n)``.

        All-integer CRT: ``y_i = r_i (P/p_i)^-1 mod p_i``;
        ``V = sum y_i (P/p_i) - alpha P`` with
        ``alpha = round(sum y_i / p_i)`` recovered in 64-bit fixed point.
        """
        k = self.count
        nd = res.ndim - 1
        q = self.modulus.value.reshape((k,) + (1,) * nd)
        f = jax.tree.map(lambda x: x.reshape((k,) + (1,) * nd), self.inv_punctured)
        y = factor_mul32(res, f, q)  # (k, ..., n) in [0, p_i)

        # alpha: accumulate y_i * floor(2^64/p_i) exactly (each < 2^64).
        tfix = jax.tree.map(lambda x: x.reshape((k,) + (1,) * nd), self.alpha_fix)
        ylo_t = U64(y, jnp.zeros_like(y))
        from ..numeric.limb import u64_mul_lo

        prod_lo = u64_mul_lo(ylo_t, tfix)  # y*t < 2^64: low 64 bits are exact
        acc_lo = jnp.zeros(res.shape[1:], dtype=_U32)
        acc_hi = jnp.zeros(res.shape[1:], dtype=_U32)
        overflow = jnp.zeros(res.shape[1:], dtype=_U32)
        for i in range(k):
            lo = acc_lo + prod_lo.lo[i]
            c1 = (lo < acc_lo).astype(_U32)
            hi = acc_hi + prod_lo.hi[i]
            c2 = (hi < acc_hi).astype(_U32)
            hi2 = hi + c1
            c3 = (hi2 < hi).astype(_U32)
            acc_lo, acc_hi = lo, hi2
            overflow = overflow + c2 + c3
        alpha = overflow + (acc_hi >> 31)

        # V mod 2^32 = sum y_i * (P/p_i) - alpha * P   (wrapping u32)
        u = self.punctured_mod_t.reshape((k,) + (1,) * nd)
        total = jnp.sum(y * u, axis=0, dtype=_U32)  # wrapping sum is fine
        return total - alpha * self.product_mod_t

    # -- composite ----------------------------------------------------------

    @functools.partial(jax.jit, static_argnums=0)
    def negacyclic_mul(self, a, b):
        """Exact ``a * b`` in ``Z_{2^32}[X]/(X^n+1)`` for torus polys."""
        fa = self.forward(a)
        fb = self.forward(b)
        extra = fa.ndim - 1
        prod = self.mul(fa, fb, extra)
        return self.recombine(self.inverse(prod))


class TorusConvolver64:
    """Exact negacyclic convolver for the 2^64 torus (U64 values).

    The reference's f64 FFT path silently loses precision above 2^53
    (torus.rs:46); this convolver is exact for the full 64-bit torus:
    centered lift into 30-bit NTT primes, per-prime NTTs, and an
    all-integer CRT recombination (alpha in 2^64 fixed point).
    ``bound_bits`` must bound |centered accumulator| (e.g.
    ``63 + log2(n * level * (k+1) * B/2)`` for an external product).
    """

    def __init__(self, log_n: int, bound_bits: int = 88):
        self.log_n = log_n
        self.n = 1 << log_n
        primes: list[int] = []
        below = None
        prod = 1
        while prod.bit_length() <= bound_bits + 3:
            p = next_ntt_prime(30, log_n, below)
            primes.append(p)
            below = p
            prod *= p
        self.primes = primes
        self.product = prod
        self.count = k = len(primes)

        self.plan = build_dcrt_plan32(log_n, primes)
        self.modulus = barrett32(np.array(primes, dtype=np.uint64))

        # centered-lift tables: 2^32 mod p and 2^64 mod p
        self.c32 = jnp.asarray(np.array([(1 << 32) % p for p in primes], dtype=np.uint32))
        self.c64 = jnp.asarray(np.array([(1 << 64) % p for p in primes], dtype=np.uint32))
        punctured = [prod // p for p in primes]
        self.inv_punctured = shoup32(
            np.array([mod_inv(pp % p, p) for pp, p in zip(punctured, primes)], dtype=np.uint64),
            np.array(primes, dtype=np.uint64),
        )
        # (P/p_i) mod 2^64 and P mod 2^64 as U64 for wrapping recombination
        self.punctured_mod_t = to_u64_pair(
            np.array([pp % (1 << 64) for pp in punctured], dtype=np.uint64)
        )
        self.product_mod_t = to_u64_pair(np.uint64(prod % (1 << 64)))
        self.alpha_fix = to_u64_pair(
            np.array([(1 << 64) // p for p in primes], dtype=np.uint64)
        )

    def _m(self, extra: int):
        shape = (self.count,) + (1,) * extra
        return jax.tree.map(lambda x: x.reshape(shape), self.modulus)

    @functools.partial(jax.jit, static_argnums=0)
    def lift(self, x: U64):
        """Centered lift: torus U64 ``(..., n)`` -> residues ``(k, ..., n)``.

        ``value = lo + hi*2^32 - 2^64*[hi >= 2^31]``; per prime:
        ``r = lo + hi*c32 - sign*c64 (mod p)`` via one Barrett pass.
        """
        k = self.count
        nd = x.lo.ndim
        m = self._m(nd)
        lo = x.lo[None]
        hi = x.hi[None]
        # lo mod p in [0,2p): barrett lazy; hi*c32: widening mul then wide reduce
        r_lo = reduce_once32(barrett_lazy_reduce32(lo, m), m.value)
        r_hi = reduce_once32(barrett_lazy_reduce32(hi, m), m.value)
        c32 = self.c32.reshape((k,) + (1,) * nd)
        c64 = self.c64.reshape((k,) + (1,) * nd)
        hi_term = mul32(r_hi, c32, m)
        r = add32(r_lo, hi_term, m.value)
        neg = (hi >> 31) != 0
        return jnp.where(neg, sub32(r, c64, m.value), r)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def forward(self, x: U64, out_factor: int = 1):
        lifted = self.lift(x)
        return dcrt_forward32(self.plan, lifted, out_factor)

    def mul(self, fa, fb, extra: int):
        return mul32(fa, fb, self._m(extra))

    @functools.partial(jax.jit, static_argnums=0)
    def inverse(self, res):
        return dcrt_inverse32(self.plan, res)

    @functools.partial(jax.jit, static_argnums=0)
    def recombine(self, res) -> U64:
        """Coefficient residues ``(k, ..., n)`` -> torus U64 ``(..., n)``."""
        from ..numeric.limb import u64_add, u64_mul_lo, u64_sub

        k = self.count
        nd = res.ndim - 1
        q = self.modulus.value.reshape((k,) + (1,) * nd)
        f = jax.tree.map(lambda x: x.reshape((k,) + (1,) * nd), self.inv_punctured)
        y = factor_mul32(res, f, q)

        from ..rns.converter import _alpha_fixed32

        alpha = _alpha_fixed32(y, self.alpha_fix)

        u = jax.tree.map(
            lambda x: x.reshape((k,) + (1,) * nd), self.punctured_mod_t
        )
        total = U64(jnp.zeros(res.shape[1:], _U32), jnp.zeros(res.shape[1:], _U32))
        for i in range(k):
            yi = U64(y[i], jnp.zeros_like(y[i]))
            ui = U64(u.lo[i], u.hi[i])
            total = u64_add(total, u64_mul_lo(yi, ui))
        alpha64 = U64(alpha, jnp.zeros_like(alpha))
        pm = U64(
            jnp.broadcast_to(self.product_mod_t.lo, alpha.shape),
            jnp.broadcast_to(self.product_mod_t.hi, alpha.shape),
        )
        return u64_sub(total, u64_mul_lo(alpha64, pm))

    @functools.partial(jax.jit, static_argnums=0)
    def negacyclic_mul(self, a: U64, b: U64) -> U64:
        """Exact ``a * b`` in ``Z_{2^64}[X]/(X^n+1)``."""
        fa = self.forward(a)
        fb = self.forward(b)
        extra = fa.ndim - 1
        prod = self.mul(fa, fb, extra)
        return self.recombine(self.inverse(prod))
