#!/usr/bin/env python
"""End-to-end demo: a homomorphic 1-bit full adder.

sum = XOR(XOR(a, b), cin); carry = OR(AND(a,b), AND(cin, XOR(a,b)))
— 10 gate bootstraps per addition, evaluated entirely on ciphertexts.
Run: python examples/boolean_circuit.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from primus_fhe_tpu import params as P
from primus_fhe_tpu.boot.gates import FALSE_MU, TRUE_MU, and_gate, nand_gate, or_gate
from primus_fhe_tpu.lattice.lwe import phase_torus32
from primus_fhe_tpu.utils.runtime import enable_compile_cache


def main():
    enable_compile_cache()
    t0 = time.time()
    ctx = P.make_context(jax.random.PRNGKey(0), P.TOY)
    print(f"keys generated in {time.time()-t0:.1f}s", flush=True)
    g = lambda f, a, b: f(
        ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, a, b, ctx.params.log_n
    )

    def xor(a, b):
        return g(and_gate, g(or_gate, a, b), g(nand_gate, a, b))

    def enc(key, bit):
        a = jax.random.bits(key, (ctx.params.lwe_dim,), dtype=jnp.uint32)
        bb = jnp.sum(a * ctx.lwe_secret, dtype=jnp.uint32) + jnp.uint32(
            TRUE_MU if bit else FALSE_MU
        )
        return jnp.concatenate([a, bb[None]])

    def dec(ct):
        ph = int(np.asarray(phase_torus32(ct, ctx.lwe_secret), dtype=np.uint32))
        return int((ph - (1 << 32) if ph >= 1 << 31 else ph) > 0)

    key = jax.random.PRNGKey(7)
    for a_bit, b_bit, c_bit in [(1, 1, 0), (1, 0, 1), (0, 0, 0), (1, 1, 1)]:
        ca = enc(jax.random.fold_in(key, 4 * a_bit + 2 * b_bit + c_bit), a_bit)
        cb = enc(jax.random.fold_in(key, 8 + 4 * a_bit + 2 * b_bit + c_bit), b_bit)
        cc = enc(jax.random.fold_in(key, 16 + 4 * a_bit + 2 * b_bit + c_bit), c_bit)
        t0 = time.time()
        ab = xor(ca, cb)
        s = xor(ab, cc)
        carry = g(or_gate, g(and_gate, ca, cb), g(and_gate, cc, ab))
        dt = time.time() - t0
        total = a_bit + b_bit + c_bit
        ok = dec(s) == (total & 1) and dec(carry) == (total >> 1)
        print(
            f"{a_bit}+{b_bit}+{c_bit}: sum={dec(s)} carry={dec(carry)} "
            f"(expect {total & 1},{total >> 1}) {'OK' if ok else 'FAIL'} [{dt:.1f}s]",
            flush=True,
        )


if __name__ == "__main__":
    main()
