#!/usr/bin/env python
"""Secondary benchmark: bootstrap and NTRU gate throughput on one GPU.

Rows (one JSON line each on stdout):

1. TFHE gate bootstrap (modulus switch, n_lwe CMux external products on
   the exact CRT-NTT backend, sample extraction) at the estimator-
   validated 128-bit profile (``params.py`` BOOLEAN_128: N=2048,
   n_lwe=630, L=3, B=2^7 — dims read from the profile), batch 64;
2. the same profile at batch 1 — single-gate latency;
3. NTRU end-to-end NAND gates/s at the named NTRU_128 profile
   (``params.py``: FINAL geometry, N=1024, q~2^20), correctness-checked
   over the full truth table.

Every timing ends in ``block_until_ready``; compilation is reported
apart.  Prints the card's name and power limit; exits non-zero without a
GPU.  Run manually: ``python bench_boot.py``.
"""

import json
import sys
import time

import numpy as np


def _time_per_call(run, reps=5):
    """Seconds per call over ``reps`` back-to-back calls (warm)."""
    import jax

    out = None
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def tfhe_row(name, log_n, k, lb, lv, n_lwe, batch, shared=None):
    """One TFHE gate-bootstrap row; returns (record, shared_keys)."""
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot import bootstrap, make_bootstrap_key
    from primus_fhe_tpu.decompose import ApproxSignedBasis32
    from primus_fhe_tpu.distr.sampling import DiscreteGaussian
    from primus_fhe_tpu.lattice import tfhe
    from primus_fhe_tpu.lattice.lwe import phase_torus32

    n = 1 << log_n
    if shared is None:
        basis = ApproxSignedBasis32(None, lb, reverse_length=lv)
        conv = tfhe.make_convolver(log_n, lv, k, lb)
        gauss = DiscreteGaussian(3.2)
        key = jax.random.PRNGKey(0)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        lwe_secret = (jax.random.bits(k1, (n_lwe,), dtype=jnp.uint32) & 1).astype(
            jnp.uint32
        )
        glwe_secret = (jax.random.bits(k2, (k, n), dtype=jnp.uint32) & 1).astype(
            jnp.uint32
        )
        t0 = time.perf_counter()
        bsk = make_bootstrap_key(k3, lwe_secret, glwe_secret, basis, gauss, conv)
        jax.block_until_ready(bsk)
        print(
            f"[bench_boot] {name}: bsk built in {time.perf_counter()-t0:.1f}s "
            f"primes={conv.primes}",
            file=sys.stderr,
        )
        shared = (basis, conv, bsk, lwe_secret, glwe_secret, k4)
    basis, conv, bsk, lwe_secret, glwe_secret, k4 = shared

    test_poly = jnp.full(n, 1 << 28, dtype=jnp.uint32)
    mus = jnp.asarray(
        np.where(
            np.arange(batch) % 2 == 0, 1 << 29, (1 << 32) - (1 << 29)
        ).astype(np.uint32)
    )
    a_part = jax.random.bits(k4, (batch, n_lwe), dtype=jnp.uint32)
    b_part = jnp.sum(a_part * lwe_secret[None], axis=1, dtype=jnp.uint32) + mus
    cts = jnp.concatenate([a_part, b_part[:, None]], axis=1)

    run = jax.jit(lambda c: bootstrap(conv, basis, bsk, c, test_poly, log_n))
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(cts))
    compile_s = time.perf_counter() - t0

    dt = _time_per_call(lambda: run(cts))
    rate = batch / dt

    ph = np.asarray(phase_torus32(out, glwe_secret.reshape(-1))).astype(np.int64)
    ph = np.where(ph >= 1 << 31, ph - (1 << 32), ph)
    expect_pos = np.arange(batch) % 2 == 0
    ok = ((ph > 0) == expect_pos).all() and (
        np.abs(np.abs(ph) - (1 << 28)) < 1 << 26
    ).all()
    print(
        f"[bench_boot] {name}: compile={compile_s:.1f}s step={dt*1e3:.2f}ms "
        f"({rate:.0f}/s) sign={'OK' if ok else 'FAIL'}",
        file=sys.stderr,
    )
    if not ok:
        raise SystemExit(f"bootstrap output incorrect ({name})")
    record = {
        "config": name,
        "metric": (
            f"batched gate bootstraps/s (N={n}, n_lwe={n_lwe}, L={lv}, "
            f"B=2^{lb}, batch={batch})"
        ),
        "value": rate,
        "unit": "bootstraps/s",
        "latency_ms_per_batch": dt * 1e3,
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
        "sign_check": "ok",
        "compile_s": compile_s,
    }
    return record, shared


def ntru_gate_row(batch=16):
    """End-to-end NTRU NAND gates/s at the named NTRU_128 profile."""
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot import ntru_blind_rotate as nb
    from primus_fhe_tpu.boot.ntru_gates import (
        false_mu,
        ntru_nand,
        true_mu,
    )
    from primus_fhe_tpu.distr.sampling import DiscreteGaussian, sample_uniform
    from primus_fhe_tpu.params import NTRU_128, make_ntru_context

    p = NTRU_128
    ctx, ks_basis = make_ntru_context(p)
    gauss = DiscreteGaussian(p.sigma)
    key = jax.random.PRNGKey(21)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    sk = nb.ntru_keygen(k1, ctx)
    s = (jax.random.bits(k2, (p.lwe_dim,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    t0 = time.perf_counter()
    evk = nb.make_ntru_bootstrap_key(k3, ctx, sk, s, gauss)
    # ksk rows are LWE samples under s: their noise must carry the LWE
    # layer's security on its own (params.py NtruParams.lwe_sigma)
    ksk = nb.make_ntru_keyswitch_key(
        k4, ctx, sk, s, ks_basis, DiscreteGaussian(p.lwe_sigma)
    )
    jax.block_until_ready(ksk)
    print(
        f"[bench_boot] NTRU_128: q={p.q} evk+ksk built in "
        f"{time.perf_counter()-t0:.1f}s",
        file=sys.stderr,
    )

    # batch of NAND inputs cycling the truth table
    tv, fv = true_mu(ctx), false_mu(ctx)
    xs = np.arange(batch) % 2
    ys = (np.arange(batch) // 2) % 2
    sv = np.asarray(s).astype(np.int64)

    # fresh encryptions carry the profile's lwe_sigma (>= the ks floor;
    # the key-generation sigma alone would leave fresh cts ~2^65-weak)
    enc_gauss = DiscreteGaussian(p.lwe_sigma)

    def enc(k, mu):
        ka, ke = jax.random.split(k)
        a = sample_uniform(ka, (p.lwe_dim,), ctx.q_int)
        e = enc_gauss.sample_mod(ke, (), ctx.q_int)
        b = (
            int(np.asarray(a, dtype=np.int64) @ sv) + int(mu) + int(e)
        ) % ctx.q_int
        return jnp.concatenate([a, jnp.asarray([b], dtype=jnp.uint32)])

    keys = jax.random.split(k5, 2 * batch)
    c1 = jnp.stack([enc(keys[i], tv if xs[i] else fv) for i in range(batch)])
    c2 = jnp.stack(
        [enc(keys[batch + i], tv if ys[i] else fv) for i in range(batch)]
    )

    run = jax.jit(lambda a, b: ntru_nand(ctx, evk, ksk, ks_basis, a, b))
    out = jax.block_until_ready(run(c1, c2))
    dt = _time_per_call(lambda: run(c1, c2))

    # decrypt and check the full truth table
    outs = np.asarray(out).astype(np.int64)
    ok = True
    for i in range(batch):
        ph = (int(outs[i, -1]) - int(outs[i, :-1] @ sv)) % ctx.q_int
        phc = ph - ctx.q_int if ph > ctx.q_int // 2 else ph
        want = 1 - (int(xs[i]) & int(ys[i]))
        got = 1 if phc > 0 else 0
        if got != want or abs(abs(phc) - tv) >= tv // 2:
            ok = False
            print(f"[bench_boot] NTRU gate MISMATCH at {i}: {phc}", file=sys.stderr)
    print(
        f"[bench_boot] NTRU_128 NAND: {dt*1e3:.1f}ms/batch "
        f"({batch/dt:.0f} gates/s) truth-table {'OK' if ok else 'FAIL'}",
        file=sys.stderr,
    )
    if not ok:
        raise SystemExit("NTRU gate output incorrect")
    return {
        "config": "ntru-128-nand",
        "metric": (
            f"NTRU NAND gates/s at NTRU_128 (N={1 << p.log_n}, q={p.q} "
            f"(~2^{p.q_bits}), n_lwe={p.lwe_dim}, B=2^{p.log_basis}, "
            f"L={p.level}, ks 2^{p.ks_log_basis}x{p.ks_level}, batch={batch})"
        ),
        "value": batch / dt,
        "unit": "gates/s",
        "latency_ms_per_batch": dt * 1e3,
        "truth_table_check": "ok",
        "platform": jax.devices()[0].platform,
        "device": jax.devices()[0].device_kind,
    }


def main():
    from primus_fhe_tpu.params import BOOLEAN_128 as BP
    from primus_fhe_tpu.utils import runtime

    runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"[bench_boot] card: {runtime.card_info()}", file=sys.stderr)

    rec, shared = tfhe_row(
        "std128-b64", BP.log_n, BP.glwe_dim, BP.log_basis, BP.level,
        BP.lwe_dim, 64,
    )
    rows = [rec]
    rec1, _ = tfhe_row(
        "std128-b1", BP.log_n, BP.glwe_dim, BP.log_basis, BP.level,
        BP.lwe_dim, 1, shared=shared,
    )
    rec1["metric"] = rec1["metric"].replace("batched gate bootstraps/s",
                                            "single-gate bootstrap latency")
    rows.append(rec1)
    rows.append(ntru_gate_row())
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
