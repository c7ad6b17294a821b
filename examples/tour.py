#!/usr/bin/env python
"""Capability tour: every layer of the framework in one runnable script.

Run: python examples/tour.py   (prints one line per layer; the
multi-device steps need >= 2 devices, e.g. on the CPU with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2)
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from primus_fhe_tpu.utils.runtime import enable_compile_cache


def step(name):
    print(f"[{time.strftime('%H:%M:%S')}] {name}", flush=True)


def main():
    enable_compile_cache()
    rng = np.random.default_rng(0)

    step("1. exact u32-limb arithmetic: 64x64->128 multiply")
    from primus_fhe_tpu.numeric import to_u64_pair, from_u64_pair, u64_mul_wide

    a, b = 0xDEADBEEFCAFEBABE, 0x123456789ABCDEF0
    lo, hi = u64_mul_wide(to_u64_pair(np.uint64(a)), to_u64_pair(np.uint64(b)))
    assert (int(from_u64_pair(hi)) << 64 | int(from_u64_pair(lo))) == a * b

    step("2. negacyclic NTT, 50-bit prime, bit-exact roundtrip")
    from primus_fhe_tpu.transforms import build_plan64, forward64, inverse64

    q = 1125899906826241
    plan = build_plan64(10, q)
    poly = rng.integers(0, q, 1024, dtype=np.uint64)
    back = from_u64_pair(inverse64(plan, forward64(plan, to_u64_pair(poly))))
    assert (back == poly).all()

    step("3. RNS: decompose/compose roundtrip over 2x50-bit moduli")
    from primus_fhe_tpu.numeric.bigint import big_from_int, big_to_ints
    from primus_fhe_tpu.rns import RNSBase64

    base = RNSBase64([1125899906826241, 1125899906629633])
    vals = [int(rng.integers(0, 1 << 63)) for _ in range(8)]
    arr = jnp.asarray(np.stack([big_from_int(v, base.big_len) for v in vals]))
    assert big_to_ints(base.compose(base.decompose(arr))).tolist() == vals

    step("4. gadget decomposition: reconstruction within the drop bound")
    from primus_fhe_tpu.decompose import ApproxSignedBasis32

    basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    v = jnp.asarray(rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32))
    digits = np.asarray(basis.decompose(v))
    for c in range(16):
        recon = sum(
            (int(digits[j][c]) - (1 << 32) if digits[j][c] >= 1 << 31 else int(digits[j][c]))
            * basis.scalars[j]
            for j in range(3)
        ) % (1 << 32)
        d = (recon - int(v[c])) % (1 << 32)
        assert min(d, (1 << 32) - d) <= basis.approximate_error_bound

    step("5. exact torus convolver (the FFT replacement)")
    from primus_fhe_tpu.transforms.torus import TorusConvolver32

    conv5 = TorusConvolver32(4, bound_bits=40)
    x = jnp.asarray(rng.integers(0, 1 << 12, 16, dtype=np.uint64).astype(np.uint32))
    delta = jnp.zeros(16, jnp.uint32).at[0].set(1)
    assert (np.asarray(conv5.negacyclic_mul(x, delta)) == np.asarray(x)).all()

    step("6. full gate bootstrap + boolean gates (TOY params)")
    from primus_fhe_tpu import params as P
    from primus_fhe_tpu.boot.gates import TRUE_MU, FALSE_MU, nand_gate
    from primus_fhe_tpu.lattice.lwe import phase_torus32

    ctx = P.make_context(jax.random.PRNGKey(1), P.TOY)

    def enc(k, bit):
        a = jax.random.bits(k, (ctx.params.lwe_dim,), dtype=jnp.uint32)
        bb = jnp.sum(a * ctx.lwe_secret, dtype=jnp.uint32) + jnp.uint32(
            TRUE_MU if bit else FALSE_MU
        )
        return jnp.concatenate([a, bb[None]])

    def dec(ct):
        ph = int(np.asarray(phase_torus32(ct, ctx.lwe_secret), dtype=np.uint32))
        return (ph - (1 << 32) if ph >= 1 << 31 else ph) > 0

    k = jax.random.PRNGKey(2)
    out = nand_gate(
        ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis,
        enc(jax.random.fold_in(k, 0), 1), enc(jax.random.fold_in(k, 1), 1),
        ctx.params.log_n,
    )
    assert dec(out) is False  # NAND(T, T)

    step("7. multi-device mesh: sharded external product (bit-identical)")
    n_dev = len(jax.devices())
    if n_dev >= 2:
        from jax.sharding import NamedSharding, PartitionSpec as Spec

        from primus_fhe_tpu.lattice import tfhe
        from primus_fhe_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(min(n_dev, 2), residue=1)
        g = jnp.asarray(rng.integers(0, 1 << 32, (2, 2, 32), dtype=np.uint64).astype(np.uint32))
        key_ntt = jnp.asarray(
            rng.integers(0, 1 << 20, (ctx.conv.count, 2, ctx.params.level, 2, 32), dtype=np.uint64).astype(np.uint32)
        )
        single = np.asarray(tfhe.external_product(ctx.conv, ctx.basis, g, key_ntt))
        gs = jax.device_put(g, NamedSharding(mesh, Spec("batch", None, None)))
        sharded = np.asarray(
            jax.jit(lambda gg: tfhe.external_product(ctx.conv, ctx.basis, gg, key_ntt))(gs)
        )
        assert (single == sharded).all()
    else:
        print("   (single device: skipped)")

    step("8. coefficient-sharded NTT round trip (ppermute exchanges)")
    if n_dev >= 2:
        from primus_fhe_tpu.parallel import (
            coeff_sharded_forward32,
            coeff_sharded_inverse32,
            make_mesh,
        )
        from primus_fhe_tpu.transforms import build_plan32, forward32

        q32, log_nc = 536813569, 8
        mesh = make_mesh(2, residue=2)
        vals = jnp.asarray(
            rng.integers(0, q32, (2, 1 << log_nc), dtype=np.uint64).astype(np.uint32)
        )
        sh = NamedSharding(mesh, Spec(None, "residue"))
        sv = jax.device_put(vals, sh)
        f = coeff_sharded_forward32(mesh, "residue", log_nc, q32, sv)
        assert (
            np.asarray(f) == np.asarray(forward32(build_plan32(log_nc, q32), vals))
        ).all()
        rt = coeff_sharded_inverse32(mesh, "residue", log_nc, q32, f)
        assert (np.asarray(rt) == np.asarray(vals)).all()
    else:
        print("   (single device: skipped)")

    step("9. overlapped sharded DCRT gadget product (compose as psum)")
    if n_dev >= 2:
        from primus_fhe_tpu.decompose import BigUintApproxSignedBasis
        from primus_fhe_tpu.lattice.dcrt import crt_glwe_mul_dcrt_ggsw
        from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
        from primus_fhe_tpu.parallel.overlap import (
            make_sharded_gadget_product,
            shard_gadget_inputs,
        )
        from primus_fhe_tpu.rns import RNSBase64
        from primus_fhe_tpu.transforms.dcrt import build_dcrt_plan64

        moduli = [1125899906826241, 1125899906629633]
        base = RNSBase64(moduli)
        b64 = BigUintApproxSignedBasis(base, 25)
        plan64 = build_dcrt_plan64(5, moduli)
        glwe64 = to_u64_pair(rng.integers(0, min(moduli), (2, 2, 32), dtype=np.uint64))
        ggsw64 = to_u64_pair(
            rng.integers(0, min(moduli), (2, b64.decompose_length, 2, 2, 32), dtype=np.uint64)
        )
        mesh = make_mesh(2, residue=2)
        fn = make_sharded_gadget_product(mesh, "residue", b64, plan64, base)
        sg, sk = shard_gadget_inputs(mesh, "residue", glwe64, ggsw64)
        ref = crt_glwe_mul_dcrt_ggsw(glwe64, ggsw64, b64, plan64, base)
        assert (from_u64_pair(fn(sg, sk)) == from_u64_pair(ref)).all()
    else:
        print("   (single device: skipped)")

    print("ALL LAYERS OK")


if __name__ == "__main__":
    main()
