"""Randomized differential sweeps: jnp kernels vs the golden model across
random (log_n, q) combinations — guards against convention drift anywhere
in the plan/transform pipeline."""

import random

import jax.numpy as jnp
import numpy as np

from primus_fhe_tpu.golden import GoldenNtt, naive_negacyclic_mul
from primus_fhe_tpu.modular import barrett32, barrett64, modops
from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
from primus_fhe_tpu.transforms import (
    build_plan32,
    build_plan64,
    forward32,
    forward64,
    inverse32,
    inverse64,
)
from primus_fhe_tpu.utils.primes import next_ntt_prime
import pytest

pytestmark = pytest.mark.slow

rng = random.Random(0xFADE)


def test_fuzz_ntt32_random_primes():
    for trial in range(4):
        log_n = rng.choice([4, 5, 6, 7])
        bits = rng.choice([20, 25, 29])
        q = next_ntt_prime(bits, log_n, rng.choice([None, 1 << (bits - 1)]))
        g = GoldenNtt(log_n, q)
        plan = build_plan32(log_n, q)
        n = 1 << log_n
        a = [rng.randrange(q) for _ in range(n)]
        got = np.asarray(forward32(plan, jnp.asarray(np.array(a, dtype=np.uint32))))
        assert got.astype(object).tolist() == g.forward(a), (log_n, q)
        back = np.asarray(inverse32(plan, jnp.asarray(got)))
        assert back.astype(object).tolist() == a, (log_n, q)


def test_fuzz_ntt64_random_primes():
    for trial in range(3):
        log_n = rng.choice([4, 5, 6])
        bits = rng.choice([35, 45, 55, 61])
        q = next_ntt_prime(bits, log_n)
        g = GoldenNtt(log_n, q)
        plan = build_plan64(log_n, q)
        n = 1 << log_n
        a = [rng.randrange(q) for _ in range(n)]
        got = from_u64_pair(forward64(plan, to_u64_pair(np.array(a, dtype=np.uint64))))
        assert got.astype(object).tolist() == g.forward(a), (log_n, q)
        back = from_u64_pair(inverse64(plan, forward64(plan, to_u64_pair(np.array(a, dtype=np.uint64)))))
        assert back.astype(object).tolist() == a, (log_n, q)


def test_fuzz_modops_edges():
    """Edge values at the modulus boundaries across random moduli."""
    for trial in range(5):
        bits = rng.choice([3, 8, 16, 29, 30])
        q = next_ntt_prime(bits, 1) if bits > 3 else 5
        m = barrett32(q)
        edges = np.array(
            [0, 1, q - 1, q // 2, q // 2 + 1, 2, q - 2], dtype=np.uint32
        )
        for a in edges:
            for b in edges:
                got = int(modops.mul32(jnp.uint32(a), jnp.uint32(b), m))
                assert got == int(a) * int(b) % q, (q, a, b)
        ja = jnp.asarray(edges)
        assert (
            np.asarray(modops.neg32(ja, jnp.uint32(q))).astype(object)
            == np.array([(-int(x)) % q for x in edges], dtype=object)
        ).all()


def test_fuzz_negacyclic_consistency():
    """negacyclic product via NTT == naive, on random small configs."""
    for trial in range(3):
        log_n = rng.choice([3, 4, 5])
        q = next_ntt_prime(rng.choice([15, 25]), log_n)
        plan = build_plan32(log_n, q)
        m = barrett32(q)
        n = 1 << log_n
        a = [rng.randrange(q) for _ in range(n)]
        b = [rng.randrange(q) for _ in range(n)]
        from primus_fhe_tpu.transforms import negacyclic_mul32

        got = np.asarray(
            negacyclic_mul32(
                plan, m, jnp.asarray(np.array(a, dtype=np.uint32)),
                jnp.asarray(np.array(b, dtype=np.uint32)),
            )
        )
        assert got.astype(object).tolist() == naive_negacyclic_mul(a, b, q)
