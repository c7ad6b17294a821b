#!/usr/bin/env python
"""On-card smoke check: the library's main paths, once, on one NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py          # phases 0-4 on one card
    python chip_smoke.py --four   # only the 4-card sharded rotation and
                                  # its single-card reference

Phases (each compiled for the card and checked; any failure exits
non-zero, and nothing is caught and turned into a pass):

0. the device: a GPU or exit; card name and power limit (``nvidia-smi``),
   JAX version, ``XLA_FLAGS``, compile-cache directory;
1. n=4096 NTT round trip (forward, Shoup pointwise multiply, inverse) on
   the 50/60/62-bit primes, rows bit-exact against the golden model;
2. BOOLEAN_128 gates: ``make_context`` (set-up time), one external
   product bit-exact between the GPU and the host CPU backend of this
   process, then NAND/AND/OR through bootstrap + key switch over the full
   truth table, decrypted with the phase inside the noise bound; gates/s
   at batch 64 and latency at batch 1;
3. NTRU_128 NAND over the full truth table;
4. the DCRT (RNS) rotation at the multi-device dry run's dims, bit-exact
   against the host CPU on a truncated scan, then the full scan timed.

The last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

MASK64 = (1 << 64) - 1

# the reference's 50-bit bench prime, its 60-bit golden prime, and a
# 62-bit prime at the top of the U64 tier
NTT_PRIMES = (1125899906826241, 1152921504606830593, 4611686018425815041)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _timed(fn, *args):
    """(seconds, result) of one call, waiting for the device."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0, out


def _steady(fn, *args, reps: int):
    """Mean seconds per call over ``reps`` back-to-back calls (warm)."""
    import jax

    out = None
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def host_cpu():
    import jax

    return jax.devices("cpu")[0]


def on_device(device, fn, *args):
    """Runs ``fn`` with every array argument committed to ``device``."""
    import jax

    args = jax.device_put(args, device)
    with jax.default_device(device):
        return jax.block_until_ready(fn(*args))


def phase_ntt(log_n: int, batch: int, primes=NTT_PRIMES, reps: int = 20) -> dict:
    """Forward (lazy) -> Shoup pointwise multiply -> inverse, per prime;
    the first and last rows are checked against the golden model."""
    import jax

    from primus_fhe_tpu.golden import GoldenNtt
    from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair, u64_full
    from primus_fhe_tpu.transforms import build_plan64, forward64, inverse64
    from primus_fhe_tpu.transforms.ntt import _shoup_lazy64

    n = 1 << log_n
    rng = np.random.default_rng(7)
    res = {}
    for q in primes:
        plan = build_plan64(log_n, q)
        data = rng.integers(0, q, size=(batch, n), dtype=np.uint64)
        key = rng.integers(0, q, size=(n,), dtype=np.uint64)
        key_pre = np.array([((int(k) << 64) // q) & MASK64 for k in key], dtype=np.uint64)
        kw, kp, qq = to_u64_pair(key), to_u64_pair(key_pre), u64_full((), q)

        @jax.jit
        def step(v, plan=plan, kw=kw, kp=kp, qq=qq):
            f = forward64(plan, v, out_factor=4)
            return inverse64(plan, _shoup_lazy64(f, kw, kp, qq), out_factor=1)

        v = to_u64_pair(data)
        compile_s, out = _timed(step, v)
        got = from_u64_pair(out)
        g = GoldenNtt(log_n, q)
        for r in (0, batch - 1):
            fwd = g.forward([int(x) for x in data[r]])
            want = g.inverse([f * int(k) % q for f, k in zip(fwd, key)])
            check([int(x) for x in got[r]] == want, f"NTT q={q} row {r} vs golden")
        dt = _steady(step, v, reps=reps)
        res[q] = {"compile_s": compile_s, "roundtrips_per_s": batch / dt}
        log(f"[ntt] q={q} ({q.bit_length()}-bit) n={n} batch={batch}: rows "
            f"0 and {batch - 1} bit-exact vs golden; compile+first {compile_s:.2f} s; "
            f"{batch / dt:.1f} round trips/s ({dt * 1e3:.3f} ms/batch)")
    return res


def _encrypt_bits(key, bits, lwe_secret, gaussian):
    """Batch of torus-2^32 LWE encryptions of gate bits (+-1/8)."""
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot.gates import FALSE_MU, TRUE_MU

    ka, ke = jax.random.split(key)
    n_lwe = lwe_secret.shape[0]
    a = jax.random.bits(ka, (len(bits), n_lwe), dtype=jnp.uint32)
    e = gaussian.sample_torus32(ke, (len(bits),))
    mu = jnp.asarray(np.where(np.asarray(bits) == 1, TRUE_MU, FALSE_MU).astype(np.uint32))
    b = jnp.sum(a * lwe_secret[None], axis=1, dtype=jnp.uint32) + mu + e
    return jnp.concatenate([a, b[:, None]], axis=1)


def _torus_phase(ct, lwe_secret) -> np.ndarray:
    """Centered decryption phase (int64) of torus-2^32 LWE samples."""
    ct = np.asarray(ct).astype(np.uint64)
    s = np.asarray(lwe_secret).astype(np.uint64)
    ph = (ct[:, -1] - (ct[:, :-1] * s[None]).sum(axis=1)) & np.uint64(0xFFFFFFFF)
    ph = ph.astype(np.int64)
    return np.where(ph >= 1 << 31, ph - (1 << 32), ph)


def phase_gates(params, batch: int, seed: int = 0, reps: int = 3) -> dict:
    """BOOLEAN-profile gates through the user entry points."""
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot.blind_rotate import blind_rotate, modulus_switch
    from primus_fhe_tpu.boot.gates import TRUE_MU, and_gate, nand_gate, or_gate
    from primus_fhe_tpu.lattice import tfhe
    from primus_fhe_tpu.lattice.keyswitch import key_switch
    from primus_fhe_tpu.params import make_context

    p = params
    t0 = time.perf_counter()
    ctx = make_context(jax.random.PRNGKey(seed), p)
    jax.block_until_ready((ctx.bsk, ctx.ksk))
    setup_s = time.perf_counter() - t0
    log(f"[gates] make_context N={p.n} n_lwe={p.lwe_dim} L={p.level} B=2^{p.log_basis} "
        f"ks 2^{p.ks_log_basis}x{p.ks_level}: set-up {setup_s:.2f} s "
        f"(bsk {ctx.bsk.nbytes / 2**20:.1f} MiB, ksk {ctx.ksk.nbytes / 2**20:.1f} MiB)")

    # one external product: device vs host CPU backend on identical inputs
    rng = np.random.default_rng(seed)
    glwe = jnp.asarray(
        rng.integers(0, 1 << 32, size=(batch, p.glwe_dim + 1, p.n), dtype=np.uint32)
    )
    key0 = ctx.bsk[0]
    ep = jax.jit(lambda g, k: tfhe.external_product(ctx.conv, ctx.basis, g, k))
    ep_s, on_dev = _timed(ep, glwe, key0)
    on_cpu = on_device(host_cpu(), ep, glwe, key0)
    check(np.array_equal(np.asarray(on_dev), np.asarray(on_cpu)),
          "external product: device vs host CPU")
    log(f"[gates] external product N={p.n} batch={batch}: device == host CPU "
        f"(bit-exact); compile+first {ep_s:.2f} s")

    bits_x = np.arange(batch) % 2
    bits_y = (np.arange(batch) // 2) % 2
    kx, ky = jax.random.split(jax.random.PRNGKey(seed + 1))
    c1 = _encrypt_bits(kx, bits_x, ctx.lwe_secret, ctx.gaussian)
    c2 = _encrypt_bits(ky, bits_y, ctx.lwe_secret, ctx.gaussian)
    args = (ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis)
    bound = 1 << 28  # half the distance from a message to the decision edge
    res = {"setup_s": setup_s}
    gates = {
        "NAND": (nand_gate, lambda x, y: 1 - (x & y)),
        "AND": (and_gate, lambda x, y: x & y),
        "OR": (or_gate, lambda x, y: x | y),
    }
    for name, (gate, truth) in gates.items():
        gate_s, out = _timed(gate, *args, c1, c2, p.log_n)
        ph = _torus_phase(out, ctx.lwe_secret)
        want = truth(bits_x, bits_y)
        err = ph - np.where(want == 1, TRUE_MU, -TRUE_MU)
        check(((ph > 0).astype(int) == want).all(), f"{name} truth table")
        check((np.abs(err) < bound).all(),
              f"{name} phase within noise bound (max |err| {np.abs(err).max()})")
        res[name] = {"first_call_s": gate_s, "max_abs_err": int(np.abs(err).max())}
        log(f"[gates] {name} batch={batch}: truth table OK over all 4 input pairs; "
            f"max |phase error| 2^{np.log2(np.abs(err).max() + 1):.2f} < 2^28; "
            f"first call {gate_s:.2f} s")

    dt = _steady(nand_gate, *args, c1, c2, p.log_n, reps=reps)
    res["gates_per_s"] = batch / dt
    log(f"[gates] NAND batch={batch}: {batch / dt:.2f} gates/s ({dt * 1e3:.1f} ms/batch)")
    lat_first, _ = _timed(nand_gate, *args, c1[:1], c2[:1], p.log_n)
    lat = _steady(nand_gate, *args, c1[:1], c2[:1], p.log_n, reps=reps)
    res["latency_ms"] = lat * 1e3
    log(f"[gates] NAND batch=1: latency {lat * 1e3:.2f} ms "
        f"(first call incl. compile {lat_first:.2f} s)")

    # compiled memory of the two halves of the gate step at this batch
    switched = modulus_switch(c1, p.log_n + 1)
    tp = jnp.full(p.n, jnp.uint32(TRUE_MU))
    big = jnp.zeros((batch, p.glwe_dim * p.n + 1), jnp.uint32)
    for label, lowered in (
        ("blind_rotate", blind_rotate.lower(ctx.conv, ctx.basis, ctx.bsk, switched, tp)),
        ("key_switch", key_switch.lower(big, ctx.ksk, ctx.ks_basis)),
    ):
        ma = lowered.compile().memory_analysis()
        res[f"{label}_temp_bytes"] = getattr(ma, "temp_size_in_bytes", None)
        log(f"[gates] memory_analysis {label} batch={batch}: {ma}")
    return res


def phase_ntru(params, batch: int, seed: int = 21, reps: int = 3) -> dict:
    """NTRU NAND over the full truth table at a named NTRU profile."""
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot import ntru_blind_rotate as nb
    from primus_fhe_tpu.boot.ntru_gates import false_mu, ntru_nand, true_mu
    from primus_fhe_tpu.distr.sampling import DiscreteGaussian, sample_uniform
    from primus_fhe_tpu.params import make_ntru_context

    p = params
    ctx, ks_basis = make_ntru_context(p)
    q = ctx.q_int
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(seed), 5)
    t0 = time.perf_counter()
    sk = nb.ntru_keygen(k1, ctx)
    s = (jax.random.bits(k2, (p.lwe_dim,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    evk = nb.make_ntru_bootstrap_key(k3, ctx, sk, s, DiscreteGaussian(p.sigma))
    # ksk rows and fresh encryptions are LWE samples under s: lwe_sigma
    lwe_gauss = DiscreteGaussian(p.lwe_sigma)
    ksk = nb.make_ntru_keyswitch_key(k4, ctx, sk, s, ks_basis, lwe_gauss)
    jax.block_until_ready((evk, ksk))
    setup_s = time.perf_counter() - t0

    xs = np.arange(batch) % 2
    ys = (np.arange(batch) // 2) % 2
    sv = np.asarray(s).astype(np.int64)
    tv, fv = true_mu(ctx), false_mu(ctx)

    def enc(key, bits):
        ka, ke = jax.random.split(key)
        a = sample_uniform(ka, (batch, p.lwe_dim), q)
        e = np.asarray(lwe_gauss.sample_mod(ke, (batch,), q)).astype(np.int64)
        mu = np.where(bits == 1, tv, fv)
        b = (np.asarray(a).astype(np.int64) @ sv + mu + e) % q
        return jnp.concatenate([a, jnp.asarray(b.astype(np.uint32))[:, None]], axis=1)

    ka, kb = jax.random.split(k5)
    c1, c2 = enc(ka, xs), enc(kb, ys)
    args = (ctx, evk, ksk, ks_basis)
    first_s, out = _timed(ntru_nand, *args, c1, c2)
    outs = np.asarray(out).astype(np.int64)
    ph = (outs[:, -1] - outs[:, :-1] @ sv) % q
    phc = np.where(ph > q // 2, ph - q, ph)
    want = 1 - (xs & ys)
    check(((phc > 0).astype(int) == want).all(), "NTRU NAND truth table")
    check((np.abs(np.abs(phc) - tv) < tv // 2).all(), "NTRU NAND phase within noise bound")
    dt = _steady(ntru_nand, *args, c1, c2, reps=reps)
    log(f"[ntru] NTRU NAND N={p.n} q={q} n_lwe={p.lwe_dim} batch={batch}: truth "
        f"table OK; key set-up {setup_s:.2f} s; first call {first_s:.2f} s; "
        f"{batch / dt:.2f} gates/s ({dt * 1e3:.1f} ms/batch)")
    return {"setup_s": setup_s, "gates_per_s": batch / dt}


def phase_dcrt(log_n: int, n_lwe: int, batch: int, check_rows: int = 2) -> dict:
    """Batched RNS rotation: device vs host CPU on the first ``check_rows``
    key rows, then the full scan on the device."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import production_rotation
    from primus_fhe_tpu.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu.numeric import U64

    plan, basis, base, bsk, lwe, acc = production_rotation(log_n, n_lwe, batch)
    rot = jax.jit(dcrt_blind_rotate_batched, static_argnums=(1, 2))
    bsk_t = U64(bsk.lo[:check_rows], bsk.hi[:check_rows])
    lwe_t = jnp.concatenate([lwe[:, :check_rows], lwe[:, -1:]], axis=1)
    dev = jax.block_until_ready(rot(plan, basis, base, bsk_t, lwe_t, acc))
    cpu = on_device(host_cpu(), lambda *a: rot(a[0], basis, base, *a[1:]),
                    plan, bsk_t, lwe_t, acc)
    check(np.array_equal(np.asarray(dev.lo), np.asarray(cpu.lo))
          and np.array_equal(np.asarray(dev.hi), np.asarray(cpu.hi)),
          "DCRT rotation (truncated scan): device vs host CPU")
    compile_s, _ = _timed(rot, plan, basis, base, bsk, lwe, acc)
    dt = _steady(rot, plan, basis, base, bsk, lwe, acc, reps=3)
    log(f"[dcrt] N={1 << log_n} 2x50-bit L={basis.decompose_length} batch={batch}: "
        f"{check_rows}-row scan device == host CPU (bit-exact); full {n_lwe}-step "
        f"scan compile+first {compile_s:.2f} s, {dt * 1e3:.1f} ms/rotation batch, "
        f"{batch * n_lwe / dt:.1f} CMux/s")
    return {"compile_s": compile_s, "cmux_per_s": batch * n_lwe / dt}


def phase_four(n_devices: int = 4, log_n: int = 10, n_lwe: int = 512) -> dict:
    """The explicit shard_map rotation on a (residue=2, batch) mesh of
    ``n_devices`` devices, bit-exact against the unsharded rotation on one."""
    import jax

    from __graft_entry__ import make_sharded_rotation_step, production_rotation
    from primus_fhe_tpu.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched

    step, (lwe, acc, bsk), (mesh, _) = make_sharded_rotation_step(
        n_devices, log_n=log_n, n_lwe=n_lwe, residue=2
    )
    batch = acc.lo.shape[0]
    shard_s, got = _timed(step, lwe, acc, bsk)
    plan, basis, base, bsk1, lwe1, acc1 = production_rotation(log_n, n_lwe, batch)
    rot = jax.jit(dcrt_blind_rotate_batched, static_argnums=(1, 2))
    t0 = time.perf_counter()
    want = on_device(jax.devices()[0], lambda *a: rot(a[0], basis, base, *a[1:]),
                     plan, bsk1, lwe1, acc1)
    one_s = time.perf_counter() - t0
    check(np.array_equal(np.asarray(got.lo), np.asarray(want.lo))
          and np.array_equal(np.asarray(got.hi), np.asarray(want.hi)),
          "sharded rotation vs single-device rotation")
    dt = _steady(step, lwe, acc, bsk, reps=3)
    log(f"[four] mesh {dict(mesh.shape)} N={1 << log_n} n_lwe={n_lwe} batch={batch}: "
        f"sharded == single device (bit-exact); sharded compile+first {shard_s:.2f} s, "
        f"single device compile+first {one_s:.2f} s; sharded {dt * 1e3:.1f} ms/step")
    return {"sharded_ms": dt * 1e3}


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(devices)}}
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded rotation and its reference")
    opts = ap.parse_args(argv)

    # keep the host CPU backend reachable for the device-vs-CPU comparisons
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"

    import jax

    from primus_fhe_tpu.utils import runtime

    dev = runtime.require_gpu()
    cache = runtime.enable_compile_cache()
    log(f"[device] {runtime.card_info()}")
    log(f"[device] jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; compile cache {cache}")

    t_all = time.perf_counter()
    if opts.four:
        check(len(jax.devices()) >= 4, "--four needs 4 devices")
        phase_four(4)
        devices = jax.devices()[:4]
    else:
        from primus_fhe_tpu.params import BOOLEAN_128, NTRU_128

        phase_ntt(12, 512)
        phase_gates(BOOLEAN_128, 64)
        phase_ntru(NTRU_128, 16)
        phase_dcrt(10, 512, 8)
        devices = jax.devices()[:1]
    for d in devices:
        stats = d.memory_stats() or {}
        log(f"[memory] {d}: peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    log(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
