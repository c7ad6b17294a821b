"""Large-n u64 NTT via four-step composition.

Factor n = A*B and express the negacyclic transform as

    batched size-A negacyclic NTTs  (root psi^B)
    one elementwise Shoup twiddle   (folds the cyclic-vs-negacyclic twist)
    batched size-B negacyclic NTTs  (root psi^A)

with block transposes between the steps.  Each sub-transform is the
staged :func:`transforms.ntt.forward64` / :func:`~transforms.ntt.inverse64`
over a plan built from an explicit power of the SAME top-level minimal
root, so the minimal-root convention of ``GoldenNtt`` is preserved and
the output is bit-identical to a single size-n transform.  The reference's
AVX-512 path reaches n <= 2^20
(crates/primus_ntt/src/ntt/prime64/avx512/internal.rs:1-73).

Valid for the full 62-bit tier q < 2^62.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

from ..golden.model import minimal_primitive_root, mod_inv
from ..modular.modops import reduce_once64
from ..numeric.limb import U64, to_u64_pair, u64_add, u64_full
from ..utils.bits import reverse_lsbs
from .ntt import _shoup_lazy64, forward64, inverse64
from .plan import build_plan64


class LargeNttPlan64:
    """Sub-plans + twiddle tables for the four-step u64 NTT."""

    def __init__(self, log_n: int, q: int, h1: int | None = None):
        if q >= 1 << 62:
            raise ValueError("LargeNttPlan64 requires q < 2^62")
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.q = q
        if h1 is None:
            h1 = log_n // 2
        h2 = log_n - h1
        self.A = A = 1 << h1
        self.B = B = 1 << h2
        psi = minimal_primitive_root(log_n + 1, q)
        self.root = psi
        omega = psi * psi % q
        self.plan_a = build_plan64(h1, q, root=pow(psi, B, q))
        self.plan_b = build_plan64(h2, q, root=pow(psi, A, q))

        two_n = 2 * n
        rev1 = [reverse_lsbs(i, h1) for i in range(A)]
        iomega = mod_inv(omega, q)

        def shoup_pair(tab):
            w = to_u64_pair(tab)
            pre = np.vectorize(
                lambda v: ((int(v) << 64) // q) & 0xFFFFFFFFFFFFFFFF,
                otypes=[np.uint64],
            )(tab)
            return w, to_u64_pair(pre)

        # forward twiddle (transposed layout [k0, r0], the step-1 output
        # grid): T'[r0,k0] = psi^{k0(1-A)} * omega^{rev1[r0] k0}
        tw = np.zeros((B, A), dtype=np.uint64)
        for k0 in range(B):
            base = pow(psi, (k0 * (1 - A)) % two_n, q)
            stepw = pow(omega, k0, q)
            # omega^{rev1[r0] k0}: build by exponent, then scatter by rev1
            pows = [0] * A
            cur = 1
            for e in range(A):
                pows[e] = cur
                cur = cur * stepw % q
            for r0 in range(A):
                tw[k0, r0] = base * pows[rev1[r0]] % q
        self.tw, self.tw_pre = shoup_pair(tw)

        # inverse twiddle (layout [r0, k0], the step-1 inverse output grid):
        # T2[r0,k0] = psi^{k0(A-1)} * omega^{-rev1[r0] k0}
        t2 = np.zeros((A, B), dtype=np.uint64)
        for r0 in range(A):
            e = rev1[r0]
            stepw = pow(iomega, e, q)
            cur = 1
            for k0 in range(B):
                t2[r0, k0] = cur * pow(psi, (k0 * (A - 1)) % two_n, q) % q
                cur = cur * stepw % q
        self.t2, self.t2_pre = shoup_pair(t2)
        self.qq = u64_full((), q)


@functools.partial(jax.jit, static_argnums=(0, 2))
def large_forward64(plan: LargeNttPlan64, values: U64, out_factor: int = 1) -> U64:
    """Forward negacyclic NTT, contract of :func:`transforms.ntt.forward64`
    (normal-order input, bit-reversed output, values < ``out_factor*q``)."""
    A, B, n = plan.A, plan.B, plan.n
    batch_shape = values.lo.shape[:-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1

    def t(x, shape, perm):
        return x.reshape(*shape).transpose(*perm)

    # columns: size-A transforms over k1 (input rows k1, lanes k0)
    v = U64(
        t(values.lo, (b, A, B), (0, 2, 1)).reshape(b * B, A),
        t(values.hi, (b, A, B), (0, 2, 1)).reshape(b * B, A),
    )
    y = forward64(plan.plan_a, v, 4)  # (b*B, A) rows k0, cols r0

    # twiddle in the [k0, r0] grid
    y = U64(y.lo.reshape(b, B, A), y.hi.reshape(b, B, A))
    y = _shoup_lazy64(y, plan.tw, plan.tw_pre, plan.qq)  # [0, 2q)

    # rows: size-B transforms over k0 for each r0
    v2 = U64(
        t(y.lo, (b, B, A), (0, 2, 1)).reshape(b * A, B),
        t(y.hi, (b, B, A), (0, 2, 1)).reshape(b * A, B),
    )
    # the staged transform is canonical or [0,4q); canonical serves 2 too
    out = forward64(plan.plan_b, v2, 4 if out_factor == 4 else 1)  # rows r0, cols r1
    return U64(
        out.lo.reshape(*batch_shape, n), out.hi.reshape(*batch_shape, n)
    )


@functools.partial(jax.jit, static_argnums=(0, 2))
def large_inverse64(plan: LargeNttPlan64, values: U64, out_factor: int = 1) -> U64:
    """Inverse negacyclic NTT, contract of :func:`transforms.ntt.inverse64`
    (bit-reversed input, normal-order output, ``inv_n`` folded via the
    sub-transforms' own ``inv_A``/``inv_B`` stages), but accepting the
    forward transform's lazy ``[0,4q)`` output directly."""
    A, B, n = plan.A, plan.B, plan.n
    batch_shape = values.lo.shape[:-1]
    b = int(np.prod(batch_shape)) if batch_shape else 1

    # rows: size-B inverses over r1 (input rows r0), [0,4q) -> [0,2q)
    values = reduce_once64(values, u64_add(plan.qq, plan.qq))
    v = U64(values.lo.reshape(b * A, B), values.hi.reshape(b * A, B))
    y = inverse64(plan.plan_b, v, 2)  # (b*A, B) rows r0, cols k0

    # twiddle in the [r0, k0] grid
    y = U64(y.lo.reshape(b, A, B), y.hi.reshape(b, A, B))
    y = _shoup_lazy64(y, plan.t2, plan.t2_pre, plan.qq)  # [0, 2q)

    # columns: size-A inverses over r0 for each k0
    v2 = U64(
        y.lo.transpose(0, 2, 1).reshape(b * B, A),
        y.hi.transpose(0, 2, 1).reshape(b * B, A),
    )
    out = inverse64(plan.plan_a, v2, out_factor)  # (b*B, A) cols k1
    out = U64(out.lo.reshape(b, B, A), out.hi.reshape(b, B, A))
    return U64(
        out.lo.transpose(0, 2, 1).reshape(*batch_shape, n),
        out.hi.transpose(0, 2, 1).reshape(*batch_shape, n),
    )
