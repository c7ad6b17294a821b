#!/usr/bin/env python
"""Benchmark: n=4096 negacyclic NTT ROUND TRIP on one GPU.

Pipeline per iteration (the honest cost every downstream op pays):
  forward NTT (lazy [0,4q) out) -> pointwise Shoup multiply -> inverse NTT
  (canonical [0,q) out), all on the 50-bit reference bench prime
  q=1125899906826241 (crates/primus_ntt/benches/bench_u64.rs:8), batch 512.

Prints the card's name and power limit and the timing to stderr, then ONE
JSON line to stdout:
  {"metric": ..., "value": N, "unit": "modmul/s", "roundtrips_per_s": N,
   "device": {...}}

The metric is NTT-equivalent modular multiplies per second: each radix-2
Harvey butterfly = one Shoup modmul, n/2*log2(n) per transform (x2 for the
round trip) plus n pointwise muls.  Exits non-zero without a GPU.
"""

import json
import sys
import time

import numpy as np


def main():
    import jax

    from primus_fhe_tpu.numeric import to_u64_pair, u64_full
    from primus_fhe_tpu.transforms import build_plan64, forward64, inverse64
    from primus_fhe_tpu.transforms.ntt import _shoup_lazy64
    from primus_fhe_tpu.utils import runtime

    dev = runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"[bench] card: {runtime.card_info()}", file=sys.stderr)

    log_n = 12
    n = 1 << log_n
    q = 1125899906826241  # 50-bit reference bench prime (Solinas 2^50-2^14+1)
    batch = 512
    reps = 200

    rng = np.random.default_rng(7)
    data = to_u64_pair(rng.integers(0, q, size=(batch, n), dtype=np.uint64))
    key = rng.integers(0, q, size=(n,), dtype=np.uint64)
    key_pre = np.asarray(
        [((int(k) << 64) // q) & 0xFFFFFFFFFFFFFFFF for k in key],
        dtype=np.uint64,
    )
    kw, kp, qq = to_u64_pair(key), to_u64_pair(key_pre), u64_full((), q)
    plan = build_plan64(log_n, q)

    @jax.jit
    def step(v):
        f = forward64(plan, v, out_factor=4)
        p = _shoup_lazy64(f, kw, kp, qq)
        return inverse64(plan, p, out_factor=1)

    t0 = time.perf_counter()
    v = jax.block_until_ready(step(data))
    compile_s = time.perf_counter() - t0
    # chained round trips (each output is the next input, canonical [0,q))
    t0 = time.perf_counter()
    for _ in range(reps):
        v = step(v)
    jax.block_until_ready(v)
    dt = time.perf_counter() - t0

    rts = reps * batch
    rate = rts * (n * log_n + n) / dt  # two transforms + pointwise per trip
    print(
        f"[bench] {dev.device_kind}: compile+first {compile_s:.2f}s, "
        f"roundtrips/s={rts / dt:.1f} ({dt / reps * 1e3:.3f} ms/batch)",
        file=sys.stderr,
    )
    print(
        json.dumps(
            {
                "metric": (
                    "n=4096 50-bit NTT round trip (fwd+pointwise+inv), "
                    "NTT-equivalent modmuls/s"
                ),
                "value": rate,
                "unit": "modmul/s",
                "roundtrips_per_s": rts / dt,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
