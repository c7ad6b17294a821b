"""Fast RNS base conversion (HPS-style).

Reference: ``crates/primus_rns/src/converter.rs:21-136`` — a converter
stores the output-by-input base-change matrix ``(Q/q_i) mod p_j``; a
conversion Shoup-adjusts each input residue by ``(Q/q_i)^-1 mod q_i`` and
takes one modular dot product per output modulus.

Design: the dot runs over the input-residue axis for *all* coefficients
at once — shape ``(in_k, N)`` -> ``(out_k, N)`` — which is precisely the
one cross-residue (cross-shard) contraction of an otherwise embarrassingly
parallel residue sharding (SURVEY.md §7 hard part 4).  Under a sharded mesh
the adjusted residues are all-gathered (or psum-reduced) over the residue
axis; see :mod:`primus_fhe_tpu.parallel`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..modular.factor import factor_mul32, factor_mul64
from ..modular.modops import dot32, dot64, mul32, sub32
from ..numeric.limb import U64, to_u64_pair
from .base import RNSBase32, RNSBase64

_U32 = jnp.uint32


def _alpha_fixed32(y, fix: U64):
    """``round(sum_i y_i / q_i)`` via 2^64 integer fixed point.

    ``y``: (in_k, ...) canonical residues; ``fix``: U64 (in_k,) holding
    ``floor(2^64 / q_i)``.  Replaces the reference's f64 aggregation
    (converter.rs exact_convert_array) with deterministic integer math;
    exact whenever the fractional part is at least ``k * 2^-34`` away from
    1/2, which the calling contracts guarantee.
    """
    from ..numeric.limb import u64_mul_lo

    in_k = y.shape[0]
    nd = y.ndim - 1
    fx = U64(
        fix.lo.reshape((in_k,) + (1,) * nd), fix.hi.reshape((in_k,) + (1,) * nd)
    )
    prod = u64_mul_lo(U64(y, jnp.zeros_like(y)), fx)  # y*fix < 2^64 exact
    acc_lo = jnp.zeros(y.shape[1:], dtype=_U32)
    acc_hi = jnp.zeros(y.shape[1:], dtype=_U32)
    overflow = jnp.zeros(y.shape[1:], dtype=_U32)
    for i in range(in_k):
        lo = acc_lo + prod.lo[i]
        c1 = (lo < acc_lo).astype(_U32)
        hi = acc_hi + prod.hi[i]
        c2 = (hi < acc_hi).astype(_U32)
        hi2 = hi + c1
        c3 = (hi2 < hi).astype(_U32)
        acc_lo, acc_hi = lo, hi2
        overflow = overflow + c2 + c3
    return overflow + (acc_hi >> 31)


class BaseConverter32:
    """Converter between two 32-bit RNS bases."""

    def __init__(self, input_base: RNSBase32, output_base: RNSBase32):
        self.input_base = input_base
        self.output_base = output_base
        matrix = np.array(
            [
                [p % pj for p in input_base.punctured_ints]
                for pj in output_base.moduli_ints
            ],
            dtype=np.uint32,
        )  # (out_k, in_k)
        self.matrix = jnp.asarray(matrix)
        self.alpha_fix = to_u64_pair(
            np.array(
                [(1 << 64) // q for q in input_base.moduli_ints], dtype=np.uint64
            )
        )
        # Q mod p_j for the alpha correction.
        self.q_mod_out = jnp.asarray(
            np.array(
                [input_base.q_product % pj for pj in output_base.moduli_ints],
                dtype=np.uint32,
            )
        )

    @functools.partial(jax.jit, static_argnums=0)
    def fast_convert(self, residues_in):
        """``(in_k, ...)`` residues -> ``(out_k, ...)`` in the output base.

        Computes the representative ``sum_i |x (Q/q_i)^-1|_{q_i} (Q/q_i)``
        which may exceed the true value by a small multiple of Q (standard
        fast-conversion slack, identical to the reference).
        """
        ib, ob = self.input_base, self.output_base
        in_k = ib.count
        nd = residues_in.ndim - 1  # batch dims after the residue axis
        q_in = ib.modulus.value.reshape((in_k,) + (1,) * nd)
        f = jax.tree.map(
            lambda x: x.reshape((in_k,) + (1,) * nd), ib.inv_punctured
        )
        adjusted = factor_mul32(residues_in, f, q_in)  # (in_k, ...)
        # Move the residue axis last for the dot, broadcast over out_k.
        adj = jnp.moveaxis(adjusted, 0, -1)[None]  # (1, ..., in_k)
        mat = self.matrix.reshape((ob.count,) + (1,) * nd + (in_k,))
        m = jax.tree.map(
            lambda x: x.reshape((ob.count,) + (1,) * nd) if jnp.ndim(x) else x,
            ob.modulus,
        )
        return dot32(adj, mat, m)  # (out_k, ...)

    @functools.partial(jax.jit, static_argnums=0)
    def exact_convert(self, residues_in):
        """Exact conversion (converter.rs ``exact_convert_array``).

        Removes the fast-conversion ``alpha * Q`` slack by recovering
        ``alpha = round(sum y_i / q_i)`` — integer fixed point instead of
        the reference's f64 sum.  Valid when the represented value is not
        within ``~k * Q * 2^-34`` of a multiple of ``Q/2`` (the same
        proximity condition as the f64 path).  Like the reference, values
        in the upper half of ``[0, Q)`` convert with *centered* semantics:
        ``V`` near ``Q`` yields ``(V - Q) mod p`` (the rounding treats it
        as the negative representative).  Output ``(out_k, ...)``.
        """
        ib, ob = self.input_base, self.output_base
        in_k = ib.count
        nd = residues_in.ndim - 1
        q_in = ib.modulus.value.reshape((in_k,) + (1,) * nd)
        f = jax.tree.map(
            lambda x: x.reshape((in_k,) + (1,) * nd), ib.inv_punctured
        )
        adjusted = factor_mul32(residues_in, f, q_in)  # y_i, canonical
        alpha = _alpha_fixed32(adjusted, self.alpha_fix)

        adj = jnp.moveaxis(adjusted, 0, -1)[None]
        mat = self.matrix.reshape((ob.count,) + (1,) * nd + (in_k,))
        m = jax.tree.map(
            lambda x: x.reshape((ob.count,) + (1,) * nd) if jnp.ndim(x) else x,
            ob.modulus,
        )
        raw = dot32(adj, mat, m)  # sum y_i (Q/q_i) mod p_j
        corr = mul32(
            jnp.broadcast_to(alpha[None], raw.shape),
            self.q_mod_out.reshape((ob.count,) + (1,) * nd),
            m,
        )
        return sub32(raw, corr, m.value)


class BaseConverter64:
    """Converter between two 62-bit RNS bases (U64 residues)."""

    def __init__(self, input_base: RNSBase64, output_base: RNSBase64):
        self.input_base = input_base
        self.output_base = output_base
        matrix = np.array(
            [
                [p % pj for p in input_base.punctured_ints]
                for pj in output_base.moduli_ints
            ],
            dtype=np.uint64,
        )
        self.matrix = to_u64_pair(matrix)  # (out_k, in_k)
        # alpha fixed point at 2^96: floor(2^96 / q_i) fits u64 iff
        # q_i >= 2^32; exact_convert requires it (typical DCRT moduli are
        # 40-60 bits).
        self._exact_ok = all(q >= 1 << 32 for q in input_base.moduli_ints)
        if self._exact_ok:
            self.alpha_fix96 = to_u64_pair(
                np.array(
                    [(1 << 96) // q for q in input_base.moduli_ints],
                    dtype=np.uint64,
                )
            )
        self.q_mod_out = to_u64_pair(
            np.array(
                [input_base.q_product % pj for pj in output_base.moduli_ints],
                dtype=np.uint64,
            )
        )

    @functools.partial(jax.jit, static_argnums=0)
    def fast_convert(self, residues_in: U64) -> U64:
        """``U64 (in_k, ...)`` residues -> ``U64 (out_k, ...)``."""
        ib, ob = self.input_base, self.output_base
        in_k = ib.count
        nd = residues_in.lo.ndim - 1

        def r(tree, shape):
            return jax.tree.map(
                lambda x: x.reshape(shape) if jnp.ndim(x) else x, tree
            )

        q_in = r(ib.modulus.value, (in_k,) + (1,) * nd)
        f = r(ib.inv_punctured, (in_k,) + (1,) * nd)
        adjusted = factor_mul64(residues_in, f, q_in)
        adj = U64(
            jnp.moveaxis(adjusted.lo, 0, -1)[None],
            jnp.moveaxis(adjusted.hi, 0, -1)[None],
        )
        mat = r(self.matrix, (ob.count,) + (1,) * nd + (in_k,))
        m = r(ob.modulus, (ob.count,) + (1,) * nd)
        return dot64(adj, mat, m)

    @functools.partial(jax.jit, static_argnums=0)
    def exact_convert(self, residues_in: U64) -> U64:
        """Exact conversion (U64 path): removes the ``alpha * Q`` slack.

        ``alpha = round(sum y_i / q_i)`` in 2^96 integer fixed point
        (per-term error < 2^-34; same centered-near-Q semantics as the
        32-bit variant).
        """
        from ..modular.modops import mul64, sub64
        from ..numeric.limb import u64_add, u64_mul_wide

        if not self._exact_ok:
            raise ValueError("exact_convert requires all input moduli >= 2^32")
        ib, ob = self.input_base, self.output_base
        in_k = ib.count
        nd = residues_in.lo.ndim - 1

        def r(tree, shape):
            return jax.tree.map(
                lambda x: x.reshape(shape) if jnp.ndim(x) else x, tree
            )

        q_in = r(ib.modulus.value, (in_k,) + (1,) * nd)
        f = r(ib.inv_punctured, (in_k,) + (1,) * nd)
        y = factor_mul64(residues_in, f, q_in)  # canonical (in_k, ...)

        # alpha: 128-bit accumulate of y_i * floor(2^96/q_i), round at 2^96.
        fx = r(self.alpha_fix96, (in_k,) + (1,) * nd)
        batch = residues_in.lo.shape[1:]
        acc_lo = U64(jnp.zeros(batch, _U32), jnp.zeros(batch, _U32))
        acc_hi = U64(jnp.zeros(batch, _U32), jnp.zeros(batch, _U32))
        for i in range(in_k):
            yi = U64(y.lo[i], y.hi[i])
            fi = U64(fx.lo[i], fx.hi[i])
            plo, phi = u64_mul_wide(yi, fi)
            new_lo = u64_add(acc_lo, plo)
            carry = ( (new_lo.hi < acc_lo.hi) | ((new_lo.hi == acc_lo.hi) & (new_lo.lo < acc_lo.lo)) ).astype(_U32)
            acc_lo = new_lo
            acc_hi = u64_add(u64_add(acc_hi, phi), U64(carry, jnp.zeros_like(carry)))
        # alpha = round(acc / 2^96) = acc_hi.hi + round bit of acc_hi.lo
        alpha = acc_hi.hi + (acc_hi.lo >> 31)

        adj = U64(
            jnp.moveaxis(y.lo, 0, -1)[None], jnp.moveaxis(y.hi, 0, -1)[None]
        )
        mat = r(self.matrix, (ob.count,) + (1,) * nd + (in_k,))
        m = r(ob.modulus, (ob.count,) + (1,) * nd)
        raw = dot64(adj, mat, m)
        alpha64 = U64(jnp.broadcast_to(alpha[None], raw.lo.shape), jnp.zeros_like(raw.lo))
        qm = r(self.q_mod_out, (ob.count,) + (1,) * nd)
        qmb = U64(
            jnp.broadcast_to(qm.lo, raw.lo.shape), jnp.broadcast_to(qm.hi, raw.hi.shape)
        )
        corr = mul64(alpha64, qmb, m)
        return sub64(raw, corr, m.value)
