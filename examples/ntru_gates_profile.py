#!/usr/bin/env python
"""NTRU boolean gates at the named NTRU_128 profile.

The mod-q mirror of examples/boolean_circuit.py: encrypt bits under a
binary LWE key mod the NTRU NTT prime, evaluate NAND/AND/OR through the
FINAL-style bootstrap (modulus switch -> NTRU blind rotation -> extract
-> key switch), decrypt, and check the truth tables.

Run: python examples/ntru_gates_profile.py
(runs on JAX's default device; on the CPU key generation at the full
n_lwe=700 dominates — set PRIMUS_NTRU_SMALL=1 for an n_lwe=16 smoke run.)
"""

import os
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from primus_fhe_tpu.boot.ntru_blind_rotate import (
    make_ntru_bootstrap_key,
    make_ntru_keyswitch_key,
    ntru_keygen,
)
from primus_fhe_tpu.boot.ntru_gates import (
    false_mu,
    ntru_and,
    ntru_nand,
    ntru_not,
    ntru_or,
    true_mu,
)
from primus_fhe_tpu.distr.sampling import DiscreteGaussian, sample_uniform
from primus_fhe_tpu.params import NTRU_128, make_ntru_context
from primus_fhe_tpu.utils.runtime import enable_compile_cache


def main():
    enable_compile_cache()
    p = NTRU_128
    n_lwe = 16 if os.environ.get("PRIMUS_NTRU_SMALL") == "1" else p.lwe_dim
    ctx, ks_basis = make_ntru_context(p)
    gauss = DiscreteGaussian(p.sigma)
    print(
        f"NTRU_128: N={1 << p.log_n} q={p.q} (~2^{p.q_bits}) n_lwe={n_lwe} "
        f"B=2^{p.log_basis} L={p.level}",
        flush=True,
    )

    t0 = time.time()
    key = jax.random.PRNGKey(7)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    sk = ntru_keygen(k1, ctx)
    s = (jax.random.bits(k2, (n_lwe,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    evk = make_ntru_bootstrap_key(k3, ctx, sk, s, gauss)
    # ksk rows are LWE samples under s: sample their noise at the
    # LWE-layer sigma, not the NTRU-side sigma
    ksk = make_ntru_keyswitch_key(
        k4, ctx, sk, s, ks_basis, DiscreteGaussian(p.lwe_sigma)
    )
    jax.block_until_ready(ksk)
    print(f"keys generated in {time.time()-t0:.1f}s", flush=True)

    sv = np.asarray(s).astype(np.int64)

    # fresh encryptions carry the profile's lwe_sigma (>= the ks floor;
    # key-generation sigma alone would leave fresh ciphertexts weak)
    enc_gauss = DiscreteGaussian(p.lwe_sigma)

    def enc(k, bit):
        ka, ke = jax.random.split(k)
        a = sample_uniform(ka, (n_lwe,), ctx.q_int)
        e = enc_gauss.sample_mod(ke, (), ctx.q_int)
        mu = true_mu(ctx) if bit else false_mu(ctx)
        b = (
            int(np.asarray(a, dtype=np.int64) @ sv) + int(mu) + int(e)
        ) % ctx.q_int
        return jnp.concatenate([a, jnp.asarray([b], dtype=jnp.uint32)])

    def dec(ct):
        a = np.asarray(ct[:-1]).astype(np.int64)
        ph = (int(ct[-1]) - int(a @ sv)) % ctx.q_int
        phc = ph - ctx.q_int if ph > ctx.q_int // 2 else ph
        t = true_mu(ctx)
        assert abs(abs(phc) - t) < t // 2, f"noise out of budget: {phc}"
        return 1 if phc > 0 else 0

    gates = {
        "NAND": (ntru_nand, lambda x, y: 1 - (x & y)),
        "AND": (ntru_and, lambda x, y: x & y),
        "OR": (ntru_or, lambda x, y: x | y),
    }
    ki = iter(jax.random.split(k5, 64))
    for name, (gate, truth) in gates.items():
        t0 = time.time()
        for x in (0, 1):
            for y in (0, 1):
                out = gate(ctx, evk, ksk, ks_basis, enc(next(ki), x), enc(next(ki), y))
                got = dec(out)
                assert got == truth(x, y), (name, x, y, got)
        print(f"{name}: truth table OK [{time.time()-t0:.1f}s]", flush=True)
    # NOT is a free negation; chain it through a bootstrap to be sure
    c = enc(next(ki), 1)
    out = ntru_nand(ctx, evk, ksk, ks_basis, ntru_not(ctx, c), ntru_not(ctx, c))
    assert dec(out) == 1  # NAND(0,0) = 1
    print("NOT -> NAND chain OK")
    print("ALL NTRU_128 GATES OK")


if __name__ == "__main__":
    main()
