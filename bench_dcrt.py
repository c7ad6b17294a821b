#!/usr/bin/env python
"""Secondary benchmark: batched DCRT (RNS) CMux throughput on one chip.

The config-5 RNS-bootstrap inner loop: one CMux = monomial rotate +
NTT-domain diff + full gadget product (compose -> multi-limb signed
decompose -> centered respread -> per-modulus NTT -> pointwise MAC).
N=1024, 2x50-bit moduli, L=4 multi-limb levels, batch of ciphertexts.

Prints the card's name and power limit, then one JSON line: CMux/s
(batch-aggregate) plus ms per CMux-step.  Exits non-zero without a GPU.
Run manually: ``python bench_dcrt.py``.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from primus_fhe_tpu.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
    from primus_fhe_tpu.decompose import BigUintApproxSignedBasis
    from primus_fhe_tpu.numeric import U64, to_u64_pair
    from primus_fhe_tpu.rns import RNSBase64
    from primus_fhe_tpu.transforms.dcrt import build_dcrt_plan64
    from primus_fhe_tpu.utils import runtime

    dev = runtime.require_gpu()
    runtime.enable_compile_cache()
    print(f"[bench_dcrt] card: {runtime.card_info()}", file=sys.stderr)

    LOG_N = int(os.environ.get("DCRT_LOG_N", 10))
    N = 1 << LOG_N
    MODULI = [1125899906826241, 1125899906629633]  # 2x50-bit
    N_LWE = int(os.environ.get("DCRT_NLWE", 16))  # steps per rotation
    BATCH = int(os.environ.get("DCRT_BATCH", 16))
    K1 = 2

    base = RNSBase64(MODULI)
    basis = BigUintApproxSignedBasis(base, 25)  # L=4 over ~100-bit Q
    plan = build_dcrt_plan64(LOG_N, MODULI)
    level = basis.decompose_length
    print(
        f"[bench_dcrt] N={N} moduli={len(MODULI)}x50-bit L={level} "
        f"n_lwe={N_LWE} batch={BATCH}",
        file=sys.stderr,
    )

    rng = np.random.default_rng(3)
    # random (well-formed range) bootstrap key material and accumulators —
    # throughput does not depend on key semantics, only shapes/ranges.
    q0 = min(MODULI)
    bsk_np = rng.integers(
        0, q0, size=(N_LWE, K1, level, len(MODULI), K1, N), dtype=np.uint64
    )
    bsk = to_u64_pair(bsk_np)
    acc_np = rng.integers(0, q0, size=(BATCH, len(MODULI), K1, N), dtype=np.uint64)
    acc0 = to_u64_pair(acc_np)
    lwe = jnp.asarray(
        rng.integers(0, 2 * N, size=(BATCH, N_LWE + 1)).astype(np.int32)
    )

    @jax.jit
    def run(lwe, acc):
        return dcrt_blind_rotate_batched(plan, basis, base, bsk, lwe, acc)

    t0 = time.perf_counter()
    jax.block_until_ready(run(lwe, acc0))
    print(f"[bench_dcrt] compile+first {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    best = None
    for _i in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(run(lwe, acc0))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    cmux = N_LWE * BATCH
    ms_per_step = best / N_LWE * 1e3
    record = {
        "metric": f"DCRT CMux/s (N={N}, 2x50-bit, L={level}, batch={BATCH})",
        "value": cmux / best,
        "unit": "cmux/s",
        "ms_per_batched_step": ms_per_step,
        "ms_per_cmux": best / cmux * 1e3,
        "device": {"platform": dev.platform, "kind": dev.device_kind},
    }
    print(json.dumps(record))


if __name__ == "__main__":
    main()
