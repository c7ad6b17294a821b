"""Print the security + noise-budget report for the shipped profiles.

Runs the in-repo core-SVP estimator (``utils/security.py`` — primal uSVP
+ dual attack, anchored on published Kyber/NewHope numbers) on every
named parameter set and checks each gate noise budget with the
``noise.py`` variance model.  Pure host math — no accelerator needed.

Run: python examples/validate_params.py
"""

import math
import sys

sys.path.insert(0, ".")

from primus_fhe_tpu import noise  # noqa: E402
from primus_fhe_tpu.decompose import ApproxSignedBasis32  # noqa: E402
from primus_fhe_tpu.params import (  # noqa: E402
    BOOLEAN_128,
    BOOLEAN_TFHE_LIB,
    NTRU_128,
    TOY,
)
from primus_fhe_tpu.utils import security as S  # noqa: E402


def gate_margin(p) -> float:
    basis = ApproxSignedBasis32(None, p.log_basis, reverse_length=p.level)
    ksb = ApproxSignedBasis32(None, p.ks_log_basis, reverse_length=p.ks_level)
    br = noise.blind_rotate(
        p.lwe_dim, p.glwe_sigma, p.n, p.glwe_dim, p.level,
        p.log_basis, basis.drop_bits,
    )
    out = noise.key_switch(
        br, p.lwe_sigma, p.glwe_dim * p.n, p.ks_level,
        p.ks_log_basis, ksb.drop_bits,
    )
    pre = noise.modulus_switch(noise.add(out, out), p.lwe_dim, p.log_n + 1)
    return pre.decryption_failure_margin(message_bits=2)


def show_tfhe(name, p):
    rep = S.tfhe_profile_security(p)
    print(f"{name}: N={p.n} k={p.glwe_dim} n_lwe={p.lwe_dim} "
          f"lwe_sigma=2^{math.log2(p.lwe_sigma):.1f} glwe_sigma={p.glwe_sigma}")
    print(f"  LWE layer : {rep['lwe'].classical_bits:6.1f} bits classical "
          f"core-SVP (beta {rep['lwe'].primal_beta})")
    print(f"  GLWE layer: {rep['glwe'].classical_bits:6.1f} bits classical "
          f"core-SVP (beta {rep['glwe'].primal_beta})")
    print(f"  gate 4-sigma margin: {gate_margin(p):.2f} (>1 means safe)")


def main():
    print("=== estimator anchors (published core-SVP numbers) ===")
    k = S.lwe_security(768, 3329, 1.0, "gaussian")
    print(f"Kyber-768  : {k.primal_classical_bits:.1f} bits (published 182)")
    nh = S.lwe_security(512, 12289, 2.0, "gaussian")
    print(f"NewHope-512: {nh.classical_bits:.1f} bits (published 112)")
    print()
    print("=== shipped profiles (bar: every layer >= 110 = category-1) ===")
    show_tfhe("BOOLEAN_128", BOOLEAN_128)
    show_tfhe("BOOLEAN_TFHE_LIB (legacy)", BOOLEAN_TFHE_LIB)
    show_tfhe("TOY (demos only)", TOY)
    p = NTRU_128
    rep = S.ntru_profile_security(p)
    print(f"NTRU_128: N={p.n} q={p.q} n_lwe={p.lwe_dim} sigma={p.sigma}")
    print(f"  NTRU key recovery: {rep['ntru'].classical_bits:6.1f} bits "
          f"(beta {rep['ntru'].primal_beta})")
    print(f"  LWE layer        : {rep['lwe'].classical_bits:6.1f} bits "
          f"(beta {rep['lwe'].primal_beta})")


if __name__ == "__main__":
    main()
