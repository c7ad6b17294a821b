"""Named parameter sets and turnkey context construction.

The reference's "config system" is Cargo features plus caller-supplied
numbers (SURVEY.md §5); here a typed parameter record plays that role —
one object carries every dimension/modulus/basis choice, and
:func:`make_context` builds all plans, keys, and tables from it.

The shipped sets follow standard TFHE-style parameterizations (the
reference publishes none).  ``TOY`` is for tests/demos; the named
128-bit profiles are validated by the in-repo core-SVP estimator
(``utils/security.py``, anchored on Kyber/NewHope published numbers):
every layer must clear **110 bits classical core-SVP** — the NIST
category-1 convention under which Kyber-512 (118) and NewHope-512 (112)
claim 128-bit security — and the gate noise budget must close with a
4-sigma decryption margin > 1 (``noise.py`` model; enforced in
``tests/test_security.py``).  Deployments should re-confirm with the
maintained public lattice estimator against their exact distributions.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """TFHE-style torus-2^32 parameter set."""

    log_n: int  # GLWE polynomial degree (N = 2^log_n)
    glwe_dim: int  # k (mask polynomial count)
    lwe_dim: int  # n_lwe
    log_basis: int  # gadget basis B = 2^log_basis (bootstrap key)
    level: int  # gadget levels (bootstrap key)
    ks_log_basis: int  # key-switch basis
    ks_level: int  # key-switch levels
    lwe_sigma: float  # LWE noise stddev (torus-2^32 units)
    glwe_sigma: float  # GLWE noise stddev

    @property
    def n(self) -> int:
        return 1 << self.log_n


TOY = TfheParams(
    log_n=5, glwe_dim=1, lwe_dim=8,
    log_basis=8, level=3, ks_log_basis=8, ks_level=3,
    lwe_sigma=3.2, glwe_sigma=3.2,
)

# Estimator-validated 128-bit boolean profile (see module docstring for
# the validation convention).  Core-SVP classical bits by
# ``utils.security.tfhe_profile_security``: LWE layer (n=630, q=2^32,
# sigma=2^18.6) ~ 111.0; GLWE layer (dim 2048 = k*N, sigma=3.2) ~ 194.
# The GLWE ring is N=2048: at q=2^32 a dim-1024 GLWE layer tops out near
# 2^100 core-SVP at any noise the gate budget can absorb — the known
# degradation of the classic N=1024 TFHE sets (kept as BOOLEAN_TFHE_LIB
# below).  Gate noise budget: 4-sigma pre-rotation margin ~ 1.27 by the
# model (``tests/test_security.py``; per-gate failure ~ 1e-7) — and an
# earlier measured noise check found the model over-predicts ~1.67x, so
# the real margin is ~2.1.
BOOLEAN_128 = TfheParams(
    log_n=11, glwe_dim=1, lwe_dim=630,
    log_basis=7, level=3, ks_log_basis=1, ks_level=12,
    lwe_sigma=2.0**18.6, glwe_sigma=3.2,
)

# The classic TFHE-lib boolean set (lwe 630 / N=1024 / alpha_lwe=2^-15 /
# alpha_bk=2^-25): its historical 128-bit claim evaluates to only ~2^98
# (LWE) / ~2^96 (GLWE) classical core-SVP under the shipped estimator —
# kept for continuity and round-over-round bench comparability, NOT as a
# 128-bit profile.
BOOLEAN_TFHE_LIB = TfheParams(
    log_n=10, glwe_dim=1, lwe_dim=630,
    log_basis=7, level=3, ks_log_basis=2, ks_level=8,
    lwe_sigma=2.0**17, glwe_sigma=128.0,
)


@dataclasses.dataclass(frozen=True)
class NtruParams:
    """NTRU (FINAL/NGS-style) mod-q parameter set.

    ``q`` must be an NTT prime ≡ 1 (mod 2^(log_n+1)); ``t_scale=8`` gives
    the ±q/8 boolean encodings the gate layer needs."""

    log_n: int  # NTRU ring degree (N = 2^log_n)
    q_bits: int  # NTRU modulus size (q = largest NTT prime < 2^q_bits)
    lwe_dim: int  # n_lwe (binary LWE dimension)
    log_basis: int  # gadget basis for the NGS external product
    level: int  # gadget levels
    ks_log_basis: int  # key-switch basis
    ks_level: int  # key-switch levels
    sigma: float  # NTRU-side noise stddev (ntru keygen + evk; mod-q units)
    # LWE-side noise stddev (mod-q units): fresh LWE encryptions AND the
    # key-switch-key rows — both are LWE samples under the binary secret
    # that the adversary sees, so both must carry the LWE layer's
    # security on their own.  (Keying the ksk at the NTRU-side sigma
    # would leak a near-noiseless LWE instance through the eval key.)
    lwe_sigma: float = 0.0

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def q(self) -> int:
        from .utils.primes import next_ntt_prime

        return next_ntt_prime(self.q_bits, self.log_n)


# 128-bit-class NTRU boolean profile: the FINAL geometry (Bonte et al.,
# EUROCRYPT'22 NGS setting) — N=1024 with a ~2^20 NTRU modulus, binary
# LWE secrets, near-ternary NTRU-side noise.  Estimator-validated
# (``utils.security.ntru_profile_security``): NTRU key recovery ~ 2^123
# classical core-SVP; the LWE layer (fresh encryptions AND ksk rows at
# lwe_sigma) clears the 110-bit category-1 bar (see module docstring).
#
# Noise-budget design, tuned against measured noise (a two-config
# calibration showed the NGS rotation term runs ~2.2x the textbook model
# while the ks term tracks it):
# * LWE dimension/noise: the ks noise floor is (gadget factor ~66 at
#   B=2 x L=12) * the security-minimum sigma, and that minimum falls
#   ~3x per +50 dimensions — n_lwe=700 needs only sigma ~28
#   (lwe_sigma=52 gives headroom, ~2^114) vs n=610 needing 126+.
#   Raising q cannot help (ks noise scales with lwe_sigma ~ q).
# * NGS gadget B=2^3 x L=6 (drop 2): rotation noise ~2.2x lower than
#   B=2^4 x L=5 at 1.2x the CMux count.
# * ks_level=16 (drop 4): the ks DROP error multiplies the NTRU secret
#   f = 1 + t*f' whose coefficients carry E[f^2] ~ t^2*2/3 ~ 43 (t=8),
#   so an 8-bit drop costs eps*sqrt(N*E[f^2]/12) ~ 15.4k — the
#   measured-constant noise floor that three configs pinned down; at
#   drop 4 it is ~1k.
# Decision margin: measured 7.6 sigma (~1e-14 per-gate failure).
# Enforced in tests/test_security.py with the f-scaled drop term.
NTRU_128 = NtruParams(
    log_n=10, q_bits=20, lwe_dim=700,
    log_basis=3, level=6, ks_log_basis=1, ks_level=16,
    sigma=0.5, lwe_sigma=52.0,
)


def make_ntru_context(params: NtruParams = NTRU_128):
    """NtruContext + key-switch basis for a named NTRU profile."""
    from .boot.ntru_blind_rotate import NtruContext
    from .decompose import ApproxSignedBasis32

    ctx = NtruContext(
        params.log_n, params.q, params.log_basis, params.level, t_scale=8
    )
    ks_basis = ApproxSignedBasis32(params.q, params.ks_log_basis, params.ks_level)
    return ctx, ks_basis


@dataclasses.dataclass
class TfheContext:
    """Everything needed to evaluate: keys, plans, bases, convolver."""

    params: TfheParams
    basis: Any
    ks_basis: Any
    conv: Any
    gaussian: Any
    lwe_secret: Any
    glwe_secret: Any
    bsk: Any
    ksk: Any


def make_context(key, params: TfheParams = TOY) -> TfheContext:
    """Generates secrets and evaluation keys for a parameter set."""
    import jax
    import jax.numpy as jnp

    from .boot import make_bootstrap_key
    from .decompose import ApproxSignedBasis32
    from .distr.sampling import DiscreteGaussian
    from .lattice import keyswitch, tfhe

    p = params
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    ks_basis = ApproxSignedBasis32(None, p.ks_log_basis, reverse_length=p.ks_level)
    conv = tfhe.make_convolver(p.log_n, p.level, p.glwe_dim, p.log_basis)
    # ctx.gaussian is the LWE-side sampler (fresh encryptions, ksk rows);
    # the bootstrap key is GLWE-encrypted and MUST use glwe_sigma — at
    # estimator-validated profiles lwe_sigma is ~2^18 while glwe_sigma
    # is ~3, and swapping them scrambles every gate.
    gaussian = DiscreteGaussian(max(p.lwe_sigma, 1e-6))
    glwe_gaussian = DiscreteGaussian(max(p.glwe_sigma, 1e-6))
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lwe_secret = (jax.random.bits(k1, (p.lwe_dim,), dtype=jnp.uint32) & 1).astype(
        jnp.uint32
    )
    glwe_secret = (
        jax.random.bits(k2, (p.glwe_dim, p.n), dtype=jnp.uint32) & 1
    ).astype(jnp.uint32)
    bsk = make_bootstrap_key(k3, lwe_secret, glwe_secret, basis, glwe_gaussian, conv)
    ksk = keyswitch.make_keyswitch_key(
        k4, glwe_secret.reshape(-1), lwe_secret, ks_basis, gaussian
    )
    return TfheContext(
        params=p, basis=basis, ks_basis=ks_basis, conv=conv, gaussian=gaussian,
        lwe_secret=lwe_secret, glwe_secret=glwe_secret, bsk=bsk, ksk=ksk,
    )


def save_keys(path: str, ctx: TfheContext) -> None:
    """Serializes evaluation keys + params to an ``.npz`` (bytes layer of
    the reference's ``impl_bytes_conversion`` for key material)."""
    import numpy as np

    np.savez_compressed(
        path,
        bsk=np.asarray(ctx.bsk),
        ksk=np.asarray(ctx.ksk),
        lwe_secret=np.asarray(ctx.lwe_secret),
        glwe_secret=np.asarray(ctx.glwe_secret),
        params=np.array(
            [
                ctx.params.log_n, ctx.params.glwe_dim, ctx.params.lwe_dim,
                ctx.params.log_basis, ctx.params.level,
                ctx.params.ks_log_basis, ctx.params.ks_level,
            ],
            dtype=np.int64,
        ),
        sigmas=np.array(
            [ctx.params.lwe_sigma, ctx.params.glwe_sigma], dtype=np.float64
        ),
    )


def load_keys(path: str) -> TfheContext:
    """Rebuilds a full context (plans/bases/convolver re-derived) from npz."""
    import jax.numpy as jnp
    import numpy as np

    from .decompose import ApproxSignedBasis32
    from .distr.sampling import DiscreteGaussian
    from .lattice import tfhe

    z = np.load(path)
    pv = z["params"]
    sig = z["sigmas"]
    params = TfheParams(
        log_n=int(pv[0]), glwe_dim=int(pv[1]), lwe_dim=int(pv[2]),
        log_basis=int(pv[3]), level=int(pv[4]),
        ks_log_basis=int(pv[5]), ks_level=int(pv[6]),
        lwe_sigma=float(sig[0]), glwe_sigma=float(sig[1]),
    )
    basis = ApproxSignedBasis32(None, params.log_basis, reverse_length=params.level)
    ks_basis = ApproxSignedBasis32(
        None, params.ks_log_basis, reverse_length=params.ks_level
    )
    conv = tfhe.make_convolver(
        params.log_n, params.level, params.glwe_dim, params.log_basis
    )
    return TfheContext(
        params=params, basis=basis, ks_basis=ks_basis, conv=conv,
        gaussian=DiscreteGaussian(max(params.lwe_sigma, 1e-6)),
        lwe_secret=jnp.asarray(z["lwe_secret"]),
        glwe_secret=jnp.asarray(z["glwe_secret"]),
        bsk=jnp.asarray(z["bsk"]), ksk=jnp.asarray(z["ksk"]),
    )
