"""The plain XLA path of every operation, at the primes, sizes and
geometries the device kernels used to cover.

- NTT: forward / inverse / the benchmark's round trip (forward lazy ->
  Shoup pointwise multiply -> inverse) against the golden model and the
  native C++ oracle, across the 30/40/49/50/60/62-bit tiers and
  Solinas and general primes; extreme lazy inputs;
- the four-step large-n NTT's staged sub-transforms;
- BOOLEAN_128's key-switch geometry (B=2 x L=12, 20 dropped bits) end to
  end at a reduced ring, and the key switch against a NumPy reference;
- key serialization of the single key format.
"""

import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.golden import GoldenNtt
from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair, u64_full
from primus_fhe_tpu.transforms import build_plan64, forward64, inverse64
from primus_fhe_tpu.transforms.ntt import _shoup_lazy64

MASK64 = (1 << 64) - 1

# (log_n, q): 50-bit Solinas bench prime, 30-bit, ~49-bit reference prime,
# 60-bit Solinas golden prime, non-Solinas 30-bit (119*2^23+1), 40-bit
# general prime, 62-bit general prime (top of the U64 tier)
PRIMES = [
    (8, 1125899906826241),
    (8, 536813569),
    (7, 562949953392641),
    (8, 1152921504606830593),
    (7, 998244353),
    (7, 1099511603713),
    (8, 4611686018425815041),
]


def _rows(q, n, count=3, seed=0):
    return np.random.default_rng(seed + q % 1000).integers(
        0, q, size=(count, n), dtype=np.uint64
    )


@pytest.mark.parametrize("log_n,q", PRIMES)
def test_roundtrip_with_pointwise_matches_golden(log_n, q):
    """The benchmark pipeline: forward (lazy out) -> Shoup pointwise ->
    inverse (canonical), row by row against the golden model."""
    n = 1 << log_n
    plan = build_plan64(log_n, q)
    vals = _rows(q, n)
    key = _rows(q, n, count=1, seed=1)[0]
    pre = np.array([((int(k) << 64) // q) & MASK64 for k in key], dtype=np.uint64)
    f = forward64(plan, to_u64_pair(vals), out_factor=4)
    prod = _shoup_lazy64(f, to_u64_pair(key), to_u64_pair(pre), u64_full((), q))
    got = from_u64_pair(inverse64(plan, prod, out_factor=1))
    g = GoldenNtt(log_n, q)
    for r in range(vals.shape[0]):
        fwd = g.forward([int(x) for x in vals[r]])
        want = g.inverse([a * int(b) % q for a, b in zip(fwd, key)])
        assert [int(x) for x in got[r]] == want


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("log_n,q", PRIMES)
def test_forward_inverse_match_native(log_n, q):
    from primus_fhe_tpu import native

    n = 1 << log_n
    plan = build_plan64(log_n, q)
    nat = native.NativeNtt(log_n, q)
    vals = _rows(q, n, seed=2)
    got_f = from_u64_pair(forward64(plan, to_u64_pair(vals)))
    assert (got_f == nat.forward(vals)).all()
    got_i = from_u64_pair(inverse64(plan, to_u64_pair(vals)))
    assert (got_i == nat.inverse(vals)).all()


@pytest.mark.parametrize("log_n,q", PRIMES)
def test_lazy_forward_is_congruent(log_n, q):
    """``out_factor=4`` stays below 4q and is congruent to canonical."""
    n = 1 << log_n
    plan = build_plan64(log_n, q)
    v = to_u64_pair(_rows(q, n, seed=3))
    canon = from_u64_pair(forward64(plan, v, out_factor=1))
    lazy = from_u64_pair(forward64(plan, v, out_factor=4))
    assert (lazy < np.uint64(4 * q)).all()
    assert (lazy % np.uint64(q) == canon).all()


@pytest.mark.parametrize(
    "log_n,q",
    [(8, 536813569), (8, 1125899906826241), (8, 1152921504606830593),
     (8, 4611686018425815041)],
)
def test_extreme_lazy_inputs(log_n, q):
    """Inputs at the top of the forward contract ([0, 4q)) and all-zero /
    all-(q-1) rows reduce to the golden transform of their residues."""
    n = 1 << log_n
    plan = build_plan64(log_n, q)
    rows = np.stack([
        np.full(n, 4 * q - 1, dtype=np.uint64),
        np.zeros(n, dtype=np.uint64),
        np.full(n, q - 1, dtype=np.uint64),
    ])
    got = from_u64_pair(forward64(plan, to_u64_pair(rows)))
    g = GoldenNtt(log_n, q)
    for r in range(rows.shape[0]):
        assert [int(x) for x in got[r]] == g.forward([int(x) % q for x in rows[r]])


# ---------------------------------------------------------------------------
# Four-step large-n NTT: staged sub-transforms from the parent root
# ---------------------------------------------------------------------------

LARGE = [
    (6, 1125899906826241),
    (7, 1152921504606830593),
    (8, 4611686018425815041),
    (9, 536813569),
]


@pytest.mark.parametrize("log_n,q", LARGE)
def test_large_subplans_match_golden_with_parent_root(log_n, q):
    from primus_fhe_tpu.transforms.ntt_large import LargeNttPlan64

    plan = LargeNttPlan64(log_n, q)
    for sub, root in ((plan.plan_a, pow(plan.root, plan.B, q)),
                      (plan.plan_b, pow(plan.root, plan.A, q))):
        g = GoldenNtt(sub.log_n, q, root=root)
        vals = _rows(q, sub.n, count=2, seed=4)
        got = from_u64_pair(forward64(sub, to_u64_pair(vals)))
        for r in range(2):
            assert [int(x) for x in got[r]] == g.forward([int(x) for x in vals[r]])


@pytest.mark.parametrize("log_n,q", LARGE)
def test_large_matches_staged_transform(log_n, q):
    """The four-step composition is bit-identical to one size-n staged
    transform, forward and inverse (the inverse also taking the
    forward's lazy output)."""
    from primus_fhe_tpu.transforms.ntt_large import (
        LargeNttPlan64,
        large_forward64,
        large_inverse64,
    )

    n = 1 << log_n
    plan = LargeNttPlan64(log_n, q)
    staged = build_plan64(log_n, q)
    v = to_u64_pair(_rows(q, n, seed=5))
    want = from_u64_pair(forward64(staged, v))
    assert (from_u64_pair(large_forward64(plan, v, 1)) == want).all()
    lazy = large_forward64(plan, v, 4)
    assert (from_u64_pair(large_inverse64(plan, lazy, 1)) == from_u64_pair(v)).all()


# ---------------------------------------------------------------------------
# BOOLEAN_128's key-switch geometry at a reduced ring
# ---------------------------------------------------------------------------


def _reduced_boolean_128():
    """BOOLEAN_128's gadgets (B=2^7 x 3 bootstrap, B=2 x 12 key switch,
    so 20 dropped ks bits) on an N=256 ring with a short LWE key and
    small noise — a CPU-sized instance of the flagship geometry."""
    from primus_fhe_tpu.params import BOOLEAN_128, TfheParams

    p = BOOLEAN_128
    return TfheParams(
        log_n=8, glwe_dim=p.glwe_dim, lwe_dim=16,
        log_basis=p.log_basis, level=p.level,
        ks_log_basis=p.ks_log_basis, ks_level=p.ks_level,
        lwe_sigma=2.0**10, glwe_sigma=p.glwe_sigma,
    )


@pytest.fixture(scope="module")
def ks_ctx():
    from primus_fhe_tpu.params import make_context

    return make_context(jax.random.PRNGKey(12), _reduced_boolean_128())


def _encrypt(key, bits, ctx):
    from primus_fhe_tpu.boot.gates import FALSE_MU, TRUE_MU

    ka, ke = jax.random.split(key)
    s = ctx.lwe_secret
    a = jax.random.bits(ka, (len(bits), s.shape[0]), dtype=jnp.uint32)
    e = ctx.gaussian.sample_torus32(ke, (len(bits),))
    mu = jnp.asarray(np.where(np.asarray(bits) == 1, TRUE_MU, FALSE_MU).astype(np.uint32))
    b = jnp.sum(a * s[None], axis=1, dtype=jnp.uint32) + mu + e
    return jnp.concatenate([a, b[:, None]], axis=1)


def _phase(ct, s):
    ct = np.asarray(ct).astype(np.uint64)
    s = np.asarray(s).astype(np.uint64)
    ph = ((ct[:, -1] - (ct[:, :-1] * s).sum(axis=1)) & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return np.where(ph >= 1 << 31, ph - (1 << 32), ph)


def test_ks_basis_geometry_of_boolean_128():
    """B=2 x 12 on the 2^32 torus: signed digits in {-1, 0, 1}, 20
    dropped bits, recomposition within half a dropped unit."""
    from primus_fhe_tpu.decompose import ApproxSignedBasis32
    from primus_fhe_tpu.params import BOOLEAN_128 as P

    basis = ApproxSignedBasis32(None, P.ks_log_basis, reverse_length=P.ks_level)
    assert basis.drop_bits == 20
    x = jnp.asarray(np.random.default_rng(6).integers(0, 1 << 32, 4096, dtype=np.uint64)
                    .astype(np.uint32))
    digits = np.asarray(basis.decompose(x)).astype(np.int64)
    digits = np.where(digits >= 1 << 31, digits - (1 << 32), digits)
    assert set(np.unique(digits)) <= {-1, 0, 1}
    scal = np.array([int(s) for s in basis.scalars], dtype=np.int64)
    back = (digits * scal[:, None]).sum(axis=0) % (1 << 32)
    err = (np.asarray(x).astype(np.int64) - back) % (1 << 32)
    err = np.where(err >= 1 << 31, err - (1 << 32), err)
    assert np.abs(err).max() <= 1 << 19


@pytest.mark.parametrize("gate,truth", [
    ("nand_gate", lambda x, y: 1 - (x & y)),
    ("and_gate", lambda x, y: x & y),
    ("or_gate", lambda x, y: x | y),
])
def test_gates_through_the_boolean_128_key_switch(ks_ctx, gate, truth):
    from primus_fhe_tpu.boot import gates

    ctx = ks_ctx
    xs = np.array([0, 0, 1, 1])
    ys = np.array([0, 1, 0, 1])
    k1, k2 = jax.random.split(jax.random.PRNGKey(len(gate)))
    c1, c2 = _encrypt(k1, xs, ctx), _encrypt(k2, ys, ctx)
    out = getattr(gates, gate)(
        ctx.conv, ctx.basis, ctx.bsk, ctx.ksk, ctx.ks_basis, c1, c2,
        ctx.params.log_n,
    )
    ph = _phase(out, ctx.lwe_secret)
    assert ((ph > 0).astype(int) == truth(xs, ys)).all()
    assert (np.abs(np.abs(ph) - (1 << 29)) < 1 << 28).all()


@pytest.mark.parametrize("batch_shape", [(), (3,), (2, 2)])
def test_key_switch_matches_numpy(ks_ctx, batch_shape):
    """The fused broadcast-multiply-reduce against an int64 NumPy
    reference of ``(0, b) - sum_{i,l} d_l(a_i) KSK[i,l]`` mod 2^32."""
    from primus_fhe_tpu.lattice.keyswitch import key_switch

    ctx = ks_ctx
    n_in = ctx.ksk.shape[0]
    rng = np.random.default_rng(7)
    lwe = rng.integers(0, 1 << 32, size=batch_shape + (n_in + 1,), dtype=np.uint64)
    lwe = lwe.astype(np.uint32)
    got = np.asarray(key_switch(jnp.asarray(lwe), ctx.ksk, ctx.ks_basis))
    digits = np.asarray(ctx.ks_basis.decompose(jnp.asarray(lwe[..., :n_in])))
    d = digits.astype(np.int64)  # (level, ..., n_in), wrapping u32 digits
    d = np.where(d >= 1 << 31, d - (1 << 32), d)  # signed, |d| <= B/2
    ksk = np.asarray(ctx.ksk).astype(np.int64)  # (n_in, level, n_out+1)
    acc = np.einsum("l...i,ilo->...o", d, ksk) % (1 << 32)
    want = np.zeros(batch_shape + (ksk.shape[-1],), dtype=np.int64)
    want[..., -1] = lwe[..., n_in]
    want = (want - acc) % (1 << 32)
    assert (got.astype(np.int64) == want).all()


@pytest.mark.parametrize("params", ["TOY", "reduced"])
def test_single_key_format_round_trips(params):
    """There is one key format: the NTT-domain bsk array that gates take
    directly; it serializes and reloads unchanged."""
    from primus_fhe_tpu import params as P

    p = P.TOY if params == "TOY" else _reduced_boolean_128()
    ctx = P.make_context(jax.random.PRNGKey(5), p)
    assert isinstance(ctx.bsk, jax.Array)
    assert ctx.bsk.shape == (
        p.lwe_dim, ctx.conv.count, p.glwe_dim + 1, p.level, p.glwe_dim + 1, p.n,
    )
    with tempfile.NamedTemporaryFile(suffix=".npz") as f:
        P.save_keys(f.name, ctx)
        back = P.load_keys(f.name)
    assert back.params == p
    assert back.bsk.dtype == ctx.bsk.dtype
    assert (np.asarray(back.bsk) == np.asarray(ctx.bsk)).all()
    assert (np.asarray(back.ksk) == np.asarray(ctx.ksk)).all()
