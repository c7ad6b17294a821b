#!/usr/bin/env python
"""Compares the device CDT Gaussian sampler against a NumPy host sampler.

Mirror of crates/primus_distr/examples/compare_samplers.rs: the reference
compares CDT vs Ziggurat; here the comparison is device CDT vs host
rounded-continuous-Gaussian (the standard approximation), reporting the
distribution distance between them.
"""

import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from primus_fhe_tpu.distr.sampling import DiscreteGaussian
from primus_fhe_tpu.distr.stats import sample_moments
from primus_fhe_tpu.utils.runtime import enable_compile_cache


def main():
    enable_compile_cache()
    sigma = float(sys.argv[1]) if len(sys.argv) > 1 else 3.2
    n = 200_000
    dev = np.asarray(
        DiscreteGaussian(sigma).sample_signed(jax.random.PRNGKey(1), (n,))
    )
    host = np.round(np.random.default_rng(1).normal(0, sigma, n)).astype(np.int64)
    for name, s in (("device CDT", dev), ("host rounded-normal", host)):
        mean, var = sample_moments(s)
        print(f"{name:22s} mean={mean:+.4f} var={var:.4f}")
    # histogram L1 distance
    lo, hi = -int(6 * sigma), int(6 * sigma)
    bins = np.arange(lo, hi + 2)
    h1, _ = np.histogram(dev, bins=bins, density=True)
    h2, _ = np.histogram(host, bins=bins, density=True)
    print(f"L1 histogram distance: {np.abs(h1 - h2).sum():.5f}")


if __name__ == "__main__":
    main()
