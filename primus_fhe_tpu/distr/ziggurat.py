"""Host-side large-sigma discrete Gaussian samplers.

Reference capabilities matched (NOT ported):

- ``DiscreteZiggurat`` — the reference's rejection sampler for sigma > 20
  (``crates/primus_distr/src/discrete_gaussian/ziggurat.rs:18``), used by
  the sigma-dispatch at ``discrete_gaussian/mod.rs:25-87``.
- ``HighPrecisionCDT`` — the reference's 256-bit ``UnixCDTSampler``
  (``discrete_gaussian/unix_cdt.rs:12``), which needs the ``rug``
  arbitrary-precision crate; Python ints are arbitrary precision natively
  and ``decimal`` supplies high-precision ``exp``, so this is a dependency-
  free equivalent.

Design: data-dependent rejection loops defeat XLA, and large-sigma
sampling only happens host-side (key/noise generation), so both samplers
are **numpy batch-rejection** designs — draw a whole batch of candidates,
keep the accepted ones, redraw only the shortfall — instead of the
reference's one-scalar-at-a-time loop.  The on-device path for every
published FHE parameter set (sigma <= ~100) remains the exact 64-bit CDT
in ``sampling.DiscreteGaussian``; these samplers exist for capability
parity and as statistical cross-checks (``tests/test_distr.py``).

Ziggurat table construction follows the published discrete-Ziggurat
scheme (Buchmann-Cabarcas-Goepfert-Huelsing-Weiden 2013): m rectangles of
equal area s over the unnormalized pmf ``rho(x) = exp(-x^2 / 2 sigma^2)``,
with s found by bisection so the top rectangle reaches ``rho(0) = 1``.
The acceptance test here is always the exact pdf comparison — the
reference's concave/convex line-segment shortcuts only exist to avoid
scalar ``exp`` calls, which a vectorized host batch does not care about.
"""

from __future__ import annotations

import decimal

import numpy as np


def _as_np_rng(rng) -> np.random.Generator:
    """Accept a numpy Generator, an int seed, or a jax PRNG key."""
    if isinstance(rng, np.random.Generator):
        return rng
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    # jax PRNGKey (old-style uint32 array or new-style typed key)
    try:
        import jax

        data = np.asarray(jax.random.key_data(rng)).ravel()
        return np.random.default_rng([int(x) for x in data])
    except Exception as e:  # pragma: no cover - defensive
        raise TypeError(f"cannot derive a numpy Generator from {rng!r}") from e


class DiscreteZiggurat:
    """Discrete Ziggurat over Z, host-side, batch-rejection.

    Matches ``ziggurat.rs:18``'s contract: integer support, symmetric,
    tail cut at ``floor(tail_cut * sigma)``; ``sample_mod`` wraps negative
    values to ``q + s`` exactly like the reference's ``combine``
    (``modulus_minus_one - x + 1``).
    """

    MAX_RECTS = 512

    def __init__(self, sigma: float, tail_cut: float = 12.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        self.sigma = float(sigma)
        self.tail_cut = float(tail_cut)
        x_m = float(np.floor(tail_cut * sigma))
        inv2s2 = 1.0 / (2.0 * self.sigma * self.sigma)
        self._inv2s2 = inv2s2

        def rho(x: float) -> float:
            return float(np.exp(-(x * x) * inv2s2))

        def build(m: int, s: float):
            """Rectangle boundaries for area s; returns (x, y) with
            x[0] = 0, x[m] = x_m, or None when an interior y >= 1."""
            x = np.zeros(m + 1)
            y = np.zeros(m + 1)
            x[m] = x_m
            y[m] = 0.0
            for i in range(m - 1, 0, -1):
                y[i] = y[i + 1] + s / (1.0 + x[i + 1])
                if y[i] >= 1.0:
                    return None
                # largest integer with rho(x) >= y[i]
                x[i] = np.floor(np.sqrt(-np.log(y[i]) / inv2s2))
            y[0] = y[1] + s / (1.0 + x[1])
            x[0] = 0.0
            return x, y

        m = 32 if x_m < 20.0 else (64 if x_m < 100.0 else 128)
        tables = None
        while m <= self.MAX_RECTS:
            # y[0](s) increases with s; bisect for y[0] = rho(0) = 1.
            lo, hi = 0.0, x_m + 1.0
            for _ in range(200):
                s = 0.5 * (lo + hi)
                t = build(m, s)
                if t is None:
                    hi = s
                else:
                    if t[1][0] >= 1.0:
                        tables = t
                        hi = s
                    else:
                        lo = s
                if hi - lo < 1e-14:
                    break
            if tables is not None and tables[1][0] >= 1.0 - 1e-9:
                break
            tables = None
            m *= 2
        if tables is None:
            raise ValueError(
                f"cannot build Ziggurat tables for sigma={sigma} "
                f"(tail_cut={tail_cut}, m up to {self.MAX_RECTS})"
            )
        x, y = tables
        self.m = m
        self.x = np.asarray(np.round(x), dtype=np.int64)  # integer bounds
        self.y = y
        self.y_diff = np.concatenate([[0.0], y[:-1] - y[1:]])  # y_diff[i]

    def _rho(self, x):
        return np.exp(-(x.astype(np.float64) ** 2) * self._inv2s2)

    def sample_signed(self, rng, shape) -> np.ndarray:
        """Signed int64 samples of the given shape (host numpy)."""
        rng = _as_np_rng(rng)
        need = int(np.prod(shape)) if shape else 1
        out = np.empty(need, dtype=np.int64)
        filled = 0
        while filled < need:
            b = max(2 * (need - filled), 1024)
            i = rng.integers(1, self.m + 1, size=b)
            xi = self.x[i]
            # inclusive uniform over [0, x[i]]
            x = rng.integers(0, xi + 1, size=b)
            core = (x > 0) & (x <= self.x[i - 1])
            zero = x == 0
            zero_ok = zero & (rng.random(b) < 0.5)
            # fringe: exact pdf test  y[i] + u * y_diff[i] <= rho(x)
            u = rng.random(b)
            fringe_ok = (
                ~core
                & ~zero
                & (self.y[i] + u * self.y_diff[i] <= self._rho(x))
            )
            sign = np.where(rng.random(b) < 0.5, -1, 1)
            vals = np.where(zero, 0, sign * x)
            acc = core | zero_ok | fringe_ok
            got = vals[acc]
            take = min(got.size, need - filled)
            out[filled : filled + take] = got[:take]
            filled += take
        return out.reshape(shape)

    def sample_mod(self, rng, shape, q: int) -> np.ndarray:
        """Samples wrapped into ``[0, q)`` (reference ``combine``)."""
        s = self.sample_signed(rng, shape).astype(object)
        return np.where(s < 0, q + s, s)


class HighPrecisionCDT:
    """256-bit fixed-point CDT sampler (``unix_cdt.rs:12`` parity).

    The table is built with ``decimal`` at 160 significant digits (far
    beyond 256 bits) and stored as exact Python ints scaled by ``2^256``;
    sampling compares 256-bit uniform draws against the table as 4x u64
    limb arrays (vectorized lexicographic searchsorted).
    """

    PRECISION_DIGITS = 160
    BITS = 256

    def __init__(self, sigma: float, tail_cut: float = 12.0):
        if sigma <= 0:
            raise ValueError("sigma must be positive")
        self.sigma = float(sigma)
        length = int(np.floor(sigma * tail_cut)) + 1
        if length > 1024:
            raise ValueError("table too long (sigma * tail_cut > 1023)")
        length = max(length, 2)

        ctx = decimal.Context(prec=self.PRECISION_DIGITS)
        s2 = ctx.multiply(decimal.Decimal(sigma), decimal.Decimal(sigma))
        inv = ctx.divide(decimal.Decimal(-1), ctx.multiply(decimal.Decimal(2), s2))
        # pdf over the POSITIVE half: pdf[0] = 1/2 (zero is split between
        # signs), pdf[k] = exp(-k^2 / 2 sigma^2)
        pdf = [ctx.divide(decimal.Decimal(1), decimal.Decimal(2))]
        for k_ in range(1, length):
            pdf.append(ctx.exp(ctx.multiply(decimal.Decimal(k_ * k_), inv)))
        total = decimal.Decimal(0)
        for p in pdf:
            total = ctx.add(total, p)
        scale = decimal.Decimal(1 << self.BITS)
        cdt = [0]
        acc = decimal.Decimal(0)
        for p in pdf:
            acc = ctx.add(acc, p)
            v = int(ctx.multiply(ctx.divide(acc, total), scale))
            cdt.append(min(v, (1 << self.BITS) - 1))
        cdt[-1] = (1 << self.BITS) - 1
        self.cdt_int = cdt  # exact ints, ascending
        # 4x u64 limb view for vectorized comparison (lsf order)
        mask = (1 << 64) - 1
        self._limbs = np.array(
            [[(v >> (64 * j)) & mask for j in range(4)] for v in cdt],
            dtype=np.uint64,
        )

    def sample_signed(self, rng, shape) -> np.ndarray:
        rng = _as_np_rng(rng)
        need = int(np.prod(shape)) if shape else 1
        r = rng.integers(0, 1 << 64, size=(need, 4), dtype=np.uint64)
        positive = (r[:, 0] & np.uint64(1)) == 1
        # idx = (#table entries <= r) - 1; lexicographic t <= r decided at
        # the first differing limb, most-significant first
        t = self._limbs  # (L, 4)
        cmp = np.zeros((need, t.shape[0]), dtype=np.int8)  # -1 lt, 0 eq, 1 gt
        for j in (3, 2, 1, 0):
            tj = t[:, j][None, :]
            rj = r[:, j][:, None]
            here = np.where(tj < rj, -1, np.where(tj > rj, 1, 0)).astype(np.int8)
            cmp = np.where(cmp == 0, here, cmp)
        le = cmp <= 0
        idx = le.sum(axis=1) - 1
        v = idx.astype(np.int64)
        v = np.where(v == 0, 0, np.where(positive, v, -v))
        return v.reshape(shape)

    def sample_mod(self, rng, shape, q: int) -> np.ndarray:
        s = self.sample_signed(rng, shape).astype(object)
        return np.where(s < 0, q + s, s)


def make_discrete_gaussian(sigma: float, tail_cut: float = 12.0):
    """Sigma-dispatch factory matching ``discrete_gaussian/mod.rs:25-87``:
    sigma < 0.7 is rejected, sigma <= 20 uses the (device-capable, exact
    64-bit) CDT sampler, larger sigma the host Ziggurat."""
    from .sampling import DiscreteGaussian

    if sigma < 0.7:
        raise ValueError(f"sigma must be >= 0.7, got {sigma}")
    if sigma <= 20.0:
        return DiscreteGaussian(sigma, tail_cut=tail_cut)
    return DiscreteZiggurat(sigma, tail_cut=tail_cut)
