"""Reference-scale NTT tests.

- n=2048: the reference's own test shape (crates/primus_ntt/tests/ntt.rs)
  with its golden primes, full golden-model parity.
- n=65536: config-2 upper bound (BASELINE.json) — roundtrip + monomial
  closed-form spot checks (naive O(n^2) oracles are infeasible here; the
  monomial law out[j] = psi^((2 rev(j)+1) d) is exact and independent).
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.golden import GoldenNtt
from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
from primus_fhe_tpu.transforms import (
    build_plan32,
    build_plan64,
    forward32,
    forward64,
    inverse64,
    monomial32,
)

pytestmark = pytest.mark.slow

rng = random.Random(2048)


@pytest.mark.parametrize(
    "q", [536813569, 562949953392641, 1152921504606830593]
)  # tests/ntt.rs:17,55,93
def test_reference_shape_n2048(q):
    log_n = 11
    n = 1 << log_n
    g = GoldenNtt(log_n, q)
    a = [rng.randrange(q) for _ in range(n)]
    expect = g.forward(a)
    if q < 1 << 30:
        plan = build_plan32(log_n, q)
        got = np.asarray(forward32(plan, jnp.asarray(np.array(a, dtype=np.uint32))))
        assert got.astype(object).tolist() == expect
    else:
        plan = build_plan64(log_n, q)
        got = from_u64_pair(forward64(plan, to_u64_pair(np.array(a, dtype=np.uint64))))
        assert got.astype(object).tolist() == expect


def test_config2_n65536_roundtrip():
    log_n = 16
    n = 1 << log_n
    q = 1125899903827969  # 50-bit prime with q = 1 mod 2^17
    plan = build_plan64(log_n, q)
    a = np.array([rng.randrange(q) for _ in range(n)], dtype=np.uint64)
    ua = to_u64_pair(a)
    back = from_u64_pair(inverse64(plan, forward64(plan, ua)))
    assert (back == a).all()


def test_config2_n65536_monomial_law():
    log_n = 16
    n = 1 << log_n
    q = 1073479681  # 30-bit tier prime with q = 1 mod 2^17
    plan = build_plan32(log_n, q)
    g = GoldenNtt(log_n, q)
    for d in (1, 12345, n - 1):
        got = np.asarray(monomial32(plan, jnp.int32(d)))
        # closed form at a few positions
        for j in (0, 1, 7, n // 2, n - 1):
            i = g.reverse_lsbs[j]
            expect = pow(g.root, (2 * i + 1) * d, q)
            assert int(got[j]) == expect, (d, j)


# ---------------------------------------------------------------------------
# Four-step fused tier (transforms.ntt_large): the config-2 62-bit bound
# (reference: crates/primus_ntt/src/ntt/prime64/avx512/internal.rs:1-73)
# ---------------------------------------------------------------------------

from primus_fhe_tpu.transforms.ntt_large import (  # noqa: E402
    LargeNttPlan64,
    large_forward64,
    large_inverse64,
)

# 62-bit prime with 2^17 | q-1 (supports n = 2^16)
Q62 = 4611686018425815041


@pytest.mark.parametrize(
    "log_n,q",
    [
        (8, 1125899906826241),  # 50-bit reference bench prime
        (9, 1152921504606830593),  # 60-bit reference prime, odd split
        (10, Q62),
    ],
)
def test_large_matches_golden(log_n, q):
    n = 1 << log_n
    g = GoldenNtt(log_n, q)
    rng = np.random.default_rng(41 + log_n)
    vals = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    plan = LargeNttPlan64(log_n, q)
    out = from_u64_pair(large_forward64(plan, to_u64_pair(vals), 1))
    inv = from_u64_pair(large_inverse64(plan, to_u64_pair(vals), 1))
    for row in range(vals.shape[0]):
        assert [int(x) for x in out[row]] == g.forward([int(x) for x in vals[row]])
        assert [int(x) for x in inv[row]] == g.inverse([int(x) for x in vals[row]])


def test_large_n65536_62bit_roundtrip():
    """The config-2 headline shape: n = 2^16, 62-bit prime, fused tier."""
    log_n, q = 16, Q62
    n = 1 << log_n
    rng = np.random.default_rng(47)
    vals = rng.integers(0, q, size=(1, n), dtype=np.uint64)
    plan = LargeNttPlan64(log_n, q)
    v = to_u64_pair(vals)
    f = large_forward64(plan, v, 4)
    assert (from_u64_pair(f) < 4 * q).all()
    rt = from_u64_pair(large_inverse64(plan, f, 1))
    assert (rt == vals).all()

    # differential vs the XLA-staged oracle (forward64 is golden-validated)
    from primus_fhe_tpu.transforms import build_plan64, forward64

    jplan = build_plan64(log_n, q)
    want = from_u64_pair(forward64(jplan, v, out_factor=1))
    got = from_u64_pair(large_forward64(plan, v, 1))
    assert (got == want).all()


def test_large_lazy_ranges():
    log_n, q = 8, 1125899906826241
    n = 1 << log_n
    rng = np.random.default_rng(53)
    vals = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    plan = LargeNttPlan64(log_n, q)
    v = to_u64_pair(vals)
    canon = from_u64_pair(large_forward64(plan, v, 1))
    for f in (2, 4):
        lazy = from_u64_pair(large_forward64(plan, v, f))
        assert (lazy < f * q).all()
        assert ((lazy % q) == canon).all()
    # lazy input accepted
    shifted = to_u64_pair(vals + np.uint64(3 * q))
    assert (from_u64_pair(large_forward64(plan, shifted, 1)) == canon).all()


@pytest.mark.parametrize("log_n,q", [(16, 1125899903827969), (10, Q62)])
def test_subplans_use_parent_root_powers(log_n, q):
    """Both sub-plans are plain staged plans over explicit powers of the
    parent's minimal root: each matches the golden model built from that
    same root, so the composition cannot drift from a size-n transform."""
    from primus_fhe_tpu.transforms import forward64, inverse64

    plan = LargeNttPlan64(log_n, q)
    rng = np.random.default_rng(9)
    for sub, root in ((plan.plan_a, pow(plan.root, plan.B, q)),
                      (plan.plan_b, pow(plan.root, plan.A, q))):
        g = GoldenNtt(sub.log_n, q, root=root)
        vals = rng.integers(0, q, size=(2, sub.n), dtype=np.uint64)
        got = from_u64_pair(forward64(sub, to_u64_pair(vals)))
        goti = from_u64_pair(inverse64(sub, to_u64_pair(vals)))
        for row in range(2):
            assert [int(x) for x in got[row]] == g.forward([int(x) for x in vals[row]])
            assert [int(x) for x in goti[row]] == g.inverse([int(x) for x in vals[row]])
