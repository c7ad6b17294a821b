"""Coefficient-sharded NTT: ppermute butterfly exchange, bit-identical to
the single-device transform."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.parallel.coeff_sharded import coeff_sharded_forward32
from primus_fhe_tpu.parallel.mesh import make_mesh
from primus_fhe_tpu.transforms import build_plan32, forward32

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

Q = 536813569


@pytest.mark.parametrize("d,log_n", [(2, 8), (4, 8), (8, 9)])
def test_coeff_sharded_matches_single(d, log_n):
    n = 1 << log_n
    mesh = make_mesh(d, residue=d)  # use the 'residue' axis as the coeff axis
    rng = np.random.default_rng(d)
    vals = jnp.asarray(rng.integers(0, Q, (3, n), dtype=np.uint64).astype(np.uint32))
    plan = build_plan32(log_n, Q)
    single = np.asarray(forward32(plan, vals))

    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded_in = jax.device_put(vals, NamedSharding(mesh, P(None, "residue")))
    out = coeff_sharded_forward32(mesh, "residue", log_n, Q, sharded_in)
    assert (np.asarray(out) == single).all()


@pytest.mark.parametrize("d,log_n", [(2, 8), (4, 8), (8, 9)])
def test_coeff_sharded_inverse32_roundtrip(d, log_n):
    """fwd (sharded) -> inv (sharded) == identity, and inv matches the
    single-device inverse bit-exactly on its own."""
    from primus_fhe_tpu.parallel.coeff_sharded import coeff_sharded_inverse32
    from primus_fhe_tpu.transforms import inverse32
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 1 << log_n
    mesh = make_mesh(d, residue=d)
    rng = np.random.default_rng(d + 20)
    vals = jnp.asarray(rng.integers(0, Q, (3, n), dtype=np.uint64).astype(np.uint32))
    plan = build_plan32(log_n, Q)
    fwd_single = forward32(plan, vals)
    inv_single = np.asarray(inverse32(plan, fwd_single))
    assert (inv_single == np.asarray(vals)).all()

    sh = NamedSharding(mesh, P(None, "residue"))
    sharded_in = jax.device_put(vals, sh)
    f = coeff_sharded_forward32(mesh, "residue", log_n, Q, sharded_in)
    out = coeff_sharded_inverse32(mesh, "residue", log_n, Q, f)
    assert (np.asarray(out) == np.asarray(vals)).all()
    # inverse alone vs single-device inverse
    out2 = coeff_sharded_inverse32(mesh, "residue", log_n, Q, jax.device_put(fwd_single, sh))
    assert (np.asarray(out2) == inv_single).all()


@pytest.mark.parametrize("d,log_n", [(2, 8), (4, 9)])
def test_coeff_sharded64_matches_single(d, log_n):
    from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
    from primus_fhe_tpu.parallel.coeff_sharded import coeff_sharded_forward64
    from primus_fhe_tpu.transforms import build_plan64, forward64
    from jax.sharding import NamedSharding, PartitionSpec as P

    q = 1125899906826241
    n = 1 << log_n
    mesh = make_mesh(d, residue=d)
    rng = np.random.default_rng(d + 10)
    raw = rng.integers(0, q, (2, n), dtype=np.uint64)
    vals = to_u64_pair(raw)
    plan = build_plan64(log_n, q)
    single = from_u64_pair(forward64(plan, vals))

    sh = NamedSharding(mesh, P(None, "residue"))
    import jax as _jax

    vs = _jax.tree.map(lambda x: _jax.device_put(x, sh), vals)
    out = coeff_sharded_forward64(mesh, "residue", log_n, q, vs)
    assert (from_u64_pair(out) == single).all()


@pytest.mark.parametrize("d,log_n", [(2, 8), (4, 9), (8, 9)])
def test_coeff_sharded64_inverse_roundtrip(d, log_n):
    """u64 fwd -> inv round trip on the sharded path."""
    from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
    from primus_fhe_tpu.parallel.coeff_sharded import (
        coeff_sharded_forward64,
        coeff_sharded_inverse64,
    )
    from primus_fhe_tpu.transforms import build_plan64, forward64, inverse64
    from jax.sharding import NamedSharding, PartitionSpec as P

    q = 1125899906826241
    n = 1 << log_n
    mesh = make_mesh(d, residue=d)
    rng = np.random.default_rng(d + 40)
    raw = rng.integers(0, q, (2, n), dtype=np.uint64)
    vals = to_u64_pair(raw)
    plan = build_plan64(log_n, q)
    fwd_single = forward64(plan, vals)
    inv_single = from_u64_pair(inverse64(plan, fwd_single))
    assert (inv_single == raw).all()

    sh = NamedSharding(mesh, P(None, "residue"))
    vs = jax.tree.map(lambda x: jax.device_put(x, sh), vals)
    f = coeff_sharded_forward64(mesh, "residue", log_n, q, vs)
    assert (from_u64_pair(f) == from_u64_pair(fwd_single)).all()
    out = coeff_sharded_inverse64(mesh, "residue", log_n, q, f)
    assert (from_u64_pair(out) == raw).all()
