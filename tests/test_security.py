"""Core-SVP estimator anchors + security/noise validation of the shipped
named profiles (``params.py``).

The estimator (``utils/security.py``) is anchored against published
core-SVP numbers; the profile tests then enforce the repo's validation
convention: every layer >= 110 bits classical core-SVP (the NIST
category-1 convention — Kyber-512 scores 118, NewHope-512 112 under the
same metric) and a gate noise budget whose 4-sigma pre-rotation margin
exceeds 1 under the ``noise.py`` model.
"""

import math

import pytest

from primus_fhe_tpu import noise
from primus_fhe_tpu.params import BOOLEAN_128, BOOLEAN_TFHE_LIB, NTRU_128, TOY
from primus_fhe_tpu.utils import security as S


# ---------------------------------------------------------------------------
# Estimator anchors (published core-SVP numbers)
# ---------------------------------------------------------------------------


def test_anchor_kyber768():
    # Kyber-768 NIST submission: primal core-SVP classical 2^182
    est = S.lwe_security(768, 3329, 1.0, "gaussian")
    assert abs(est.primal_classical_bits - 182) <= 4
    assert abs(est.dual_classical_bits - 182) <= 6


def test_anchor_newhope512():
    # NewHope-512 submission: known-classical core-SVP 2^112 (sigma = sqrt(8/2))
    est = S.lwe_security(512, 12289, 2.0, "gaussian")
    assert abs(est.classical_bits - 112) <= 4


def test_monotonicity():
    q = float(1 << 32)
    lo = S.lwe_security(630, q, 2.0**15, "binary").classical_bits
    hi = S.lwe_security(630, q, 2.0**18, "binary").classical_bits
    assert hi > lo  # more noise, more security
    big = S.lwe_security(800, q, 2.0**15, "binary").classical_bits
    assert big > lo  # more dimension, more security
    # binary secrets are weaker than gaussian ones at the same width
    g = S.lwe_security(630, q, 2.0**15, "gaussian").classical_bits
    assert g >= lo


def test_required_sigma_roundtrip():
    q = float(1 << 32)
    sig = S.required_sigma(630, q, 110.0, "binary")
    assert S.lwe_security(630, q, sig, "binary").classical_bits >= 110.0
    # 20% less noise must fall short (the search is tight)
    assert S.lwe_security(630, q, sig / 1.2, "binary").classical_bits < 110.0


# ---------------------------------------------------------------------------
# Shipped profiles: security
# ---------------------------------------------------------------------------


def test_boolean_128_layers_clear_the_bar():
    rep = S.tfhe_profile_security(BOOLEAN_128)
    assert rep["lwe"].classical_bits >= 110.0
    assert rep["glwe"].classical_bits >= 110.0
    assert rep["classical_bits"] >= 110.0


def test_boolean_tfhe_lib_is_documented_as_degraded():
    # the classic 630/1024 set must NOT silently pass the 128-bit bar —
    # its docstring documents ~2^96-98; fail if the estimate drifts
    rep = S.tfhe_profile_security(BOOLEAN_TFHE_LIB)
    assert 88.0 <= rep["classical_bits"] <= 106.0


def test_ntru_128_layers_clear_the_bar():
    rep = S.ntru_profile_security(NTRU_128)
    assert rep["ntru"].classical_bits >= 110.0
    assert rep["lwe"].classical_bits >= 110.0


def test_ntru_128_noise_budget_closes():
    """The decode budget must close WITH the ksk sampled at the
    LWE-layer sigma (the security-mandated level): total pre-decision
    sigma vs the q/16 boolean margin.  This enforces the MODEL floor;
    the measured noise of the shipped profile (ks 2^1x16) runs 1.49x the
    model, leaving a 7.6-sigma real margin — see the NTRU_128 comment for
    the levers if lower failure rates are needed."""
    p = NTRU_128
    q = p.q
    # key switch (N -> n_lwe) at ksk noise lwe_sigma: gadget + drop.
    # The drop error multiplies the NTRU secret f = 1 + t*f' (ternary
    # f'), E[f^2] ~ t^2 * 2/3 — NOT a binary secret's 1/2 (measured:
    # the 8-bit-drop config's 15.4k noise floor).
    bks2 = float(1 << (2 * p.ks_log_basis))
    ks_gadget = p.n * p.ks_level * (bks2 / 12.0) * p.lwe_sigma**2
    drop = q.bit_length() - p.ks_log_basis * p.ks_level
    eps = float(1 << drop) if drop > 0 else 0.0
    t = 8.0  # make_ntru_context t_scale
    ks_drop = p.n * (eps * eps / 12.0) * (t * t * 2.0 / 3.0)
    # blind rotation: sigma * (B/2) * sqrt(N * L * n_lwe)
    rot = (p.sigma * (1 << p.log_basis) / 2.0) ** 2 * p.n * p.level * p.lwe_dim
    # modulus switch to 2N
    step = q / (2.0 * p.n)
    ms = (p.lwe_dim + 1) * step * step / 48.0
    total = math.sqrt(ks_gadget + ks_drop + rot + ms + p.lwe_sigma**2)
    margin = (q / 16.0) / (4.0 * total)
    assert margin > 1.2, f"NTRU gate margin {margin:.2f} too small"


def test_toy_is_toy():
    rep = S.tfhe_profile_security(TOY)
    assert rep["classical_bits"] < 60.0  # demos only, never secure


# ---------------------------------------------------------------------------
# Shipped profiles: noise budget (gate decryption margin)
# ---------------------------------------------------------------------------


def _gate_margin(p) -> float:
    """4-sigma pre-rotation margin of a 2-input gate whose operands are
    fresh bootstrap outputs (the worst standard-pipeline case), using the
    real basis drop_bits the context would derive."""
    from primus_fhe_tpu.decompose import ApproxSignedBasis32

    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    ks_basis = ApproxSignedBasis32(None, p.ks_log_basis, reverse_length=p.ks_level)
    br = noise.blind_rotate(
        p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level,
        p.log_basis, basis.drop_bits,
    )
    out = noise.key_switch(
        br, p.lwe_sigma, p.glwe_dim * p.n, p.ks_level,
        p.ks_log_basis, ks_basis.drop_bits,
    )
    lin = noise.add(out, out)
    pre = noise.modulus_switch(lin, p.lwe_dim, p.log_n + 1)
    return pre.decryption_failure_margin(message_bits=2)


def test_boolean_128_gate_margin_closes():
    assert _gate_margin(BOOLEAN_128) > 1.2


def test_boolean_tfhe_lib_gate_margin_closes():
    assert _gate_margin(BOOLEAN_TFHE_LIB) > 1.5


def test_large_sigma_sampler_moments():
    """The rounded-continuous path BOOLEAN_128's lwe_sigma now takes must
    deliver the right variance (fresh-noise accounting depends on it)."""
    import jax
    import numpy as np

    from primus_fhe_tpu.distr.sampling import DiscreteGaussian

    g = DiscreteGaussian(BOOLEAN_128.lwe_sigma)
    assert g.offsets is None  # large-sigma path selected
    s = np.asarray(g.sample_signed(jax.random.PRNGKey(3), (200_000,)))
    assert abs(s.mean()) < BOOLEAN_128.lwe_sigma * 0.02
    assert s.std() == pytest.approx(BOOLEAN_128.lwe_sigma, rel=0.02)
    # torus wrap must sign-extend correctly
    t = np.asarray(g.sample_torus32(jax.random.PRNGKey(4), (1000,))).astype(np.int64)
    t = np.where(t >= 1 << 31, t - (1 << 32), t)
    assert abs(t).max() < 12 * BOOLEAN_128.lwe_sigma
