"""Debug-mode lazy-range contract checks (PRIMUS_DEBUG=1).

Reference discipline: ``debug_assert!`` range guards at every kernel
boundary (crates/primus_ntt/src/ntt/prime64/avx512/internal.rs:61-73),
compiled away in release.  Here the flag is read at trace time, so these
tests use shapes no other test traces (batch=5, log_n=4) to guarantee the
checked executable is built under the flag.
"""

import numpy as np
import pytest

from primus_fhe_tpu.numeric import to_u64_pair
from primus_fhe_tpu.transforms import build_plan32, build_plan64, forward32, forward64, inverse32
from primus_fhe_tpu.utils import contracts

Q32 = 536813569  # 30-bit, q ≡ 1 mod 32
Q64 = 1125899906826241  # 50-bit reference bench prime
LOG_N = 4
N = 1 << LOG_N
RNG = np.random.default_rng(31)


def _v32(shift=0):
    return (RNG.integers(0, Q32, size=(5, N), dtype=np.uint64) + shift).astype(
        np.uint32
    )


def _v64(shift=0):
    return to_u64_pair(RNG.integers(0, Q64, size=(5, N), dtype=np.uint64) + np.uint64(shift))


def test_disabled_by_default(monkeypatch):
    monkeypatch.delenv("PRIMUS_DEBUG", raising=False)
    assert not contracts.enabled()
    # out-of-contract input passes silently (release-mode behavior)
    plan = build_plan32(LOG_N, Q32)
    forward32(plan, _v32(shift=3 * Q32), out_factor=4).block_until_ready()


def test_u32_violation_fails_loudly(monkeypatch):
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    assert contracts.enabled()
    plan = build_plan32(LOG_N, Q32)
    # in-contract: [0, 4q) accepted
    forward32(plan, _v32(shift=2 * Q32), out_factor=1).block_until_ready()
    # violation: inverse expects [0, 2q)
    with pytest.raises(Exception, match="range contract"):
        inverse32(plan, _v32(shift=3 * Q32), out_factor=1).block_until_ready()


def test_u64_violation_fails_loudly(monkeypatch):
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    plan = build_plan64(LOG_N, Q64)
    out = forward64(plan, _v64(shift=3 * Q64), out_factor=1)  # < 4q: fine
    out.lo.block_until_ready()
    with pytest.raises(Exception, match="range contract"):
        bad = _v64(shift=4 * Q64)  # >= 4q: breaks the forward contract
        forward64(plan, bad, out_factor=1).lo.block_until_ready()


def test_inverse_in_factor_contract(monkeypatch):
    """The staged inverse takes [0,2q); the four-step inverse also takes
    the forward's lazy [0,4q) output, because it reduces it first."""
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    from primus_fhe_tpu.transforms import inverse64
    from primus_fhe_tpu.transforms.ntt_large import LargeNttPlan64, large_inverse64

    plan = build_plan64(LOG_N, Q64)
    inverse64(plan, _v64(shift=Q64), out_factor=1).lo.block_until_ready()
    wide = _v64(shift=3 * Q64)  # < 4q
    large_inverse64(LargeNttPlan64(LOG_N, Q64), wide, 1).lo.block_until_ready()
    with pytest.raises(Exception, match="range contract"):
        inverse64(plan, wide, out_factor=1).lo.block_until_ready()


def test_golden_agreement_under_debug(monkeypatch):
    """The checks are observers only: checked results equal unchecked."""
    monkeypatch.setenv("PRIMUS_DEBUG", "1")
    from primus_fhe_tpu.golden.model import GoldenNtt
    from primus_fhe_tpu.numeric import from_u64_pair

    plan = build_plan64(LOG_N, Q64)
    g = GoldenNtt(LOG_N, Q64)
    vals = RNG.integers(0, Q64, size=(5, N), dtype=np.uint64)
    got = from_u64_pair(forward64(plan, to_u64_pair(vals), out_factor=1))
    for r in range(5):
        assert [int(x) for x in got[r]] == g.forward([int(x) for x in vals[r]])
