#!/usr/bin/env python
"""Statistical validation of the discrete Gaussian sampler.

Mirror of the reference's validation executable
(crates/primus_distr/examples/check_gaaussian.rs pattern): draws a large
sample, reports moments and the Kolmogorov-Smirnov distance against the
ideal discrete Gaussian.  Run: python examples/check_gaussian.py [sigma]
"""

import sys

import jax
import numpy as np

sys.path.insert(0, ".")

from primus_fhe_tpu.distr.sampling import DiscreteGaussian
from primus_fhe_tpu.distr.stats import chi2_statistic, max_cdf_distance, sample_moments
from primus_fhe_tpu.utils.runtime import enable_compile_cache


def main():
    enable_compile_cache()
    sigma = float(sys.argv[1]) if len(sys.argv) > 1 else 3.2
    n = 200_000
    g = DiscreteGaussian(sigma)
    s = np.asarray(g.sample_signed(jax.random.PRNGKey(0), (n,)))
    mean, var = sample_moments(s)
    ks = max_cdf_distance(s, sigma, int(10 * sigma) + 2)
    chi2 = chi2_statistic(s, sigma, int(6 * sigma))
    print(f"sigma={sigma} n={n}")
    print(f"  mean={mean:+.4f} (ideal 0)   var={var:.4f} (ideal {sigma**2:.4f})")
    print(f"  KS distance={ks:.5f}   chi2={chi2:.1f}")


if __name__ == "__main__":
    main()
