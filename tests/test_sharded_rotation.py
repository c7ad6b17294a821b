"""Explicit shard_map DCRT blind rotation vs the auto-SPMD reference.

8 virtual CPU devices, (residue=2 x batch=4) mesh: must be BIT-EXACT
against dcrt_blind_rotate_batched.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from primus_fhe_tpu.boot.dcrt_blind_rotate import dcrt_blind_rotate_batched
from primus_fhe_tpu.decompose import BigUintApproxSignedBasis
from primus_fhe_tpu.numeric import to_u64_pair
from primus_fhe_tpu.parallel.mesh import make_mesh
from primus_fhe_tpu.parallel.sharded_rotation import (
    make_sharded_blind_rotation,
    shard_rotation_inputs,
)
from primus_fhe_tpu.rns import RNSBase64
from primus_fhe_tpu.transforms.dcrt import build_dcrt_plan64

pytestmark = [
    pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices"),
    pytest.mark.slow,
]

MODULI = [1125899906826241, 1125899906629633]
# 60-bit Solinas golden prime + a general 60-bit neighbour (the
# reference's AVX-512 range)
MODULI60 = [1152921504606830593, 1152921504606748673]


def _setup(log_n, n_lwe, batch, log_basis=25, moduli=MODULI):
    n = 1 << log_n
    base = RNSBase64(moduli)
    basis = BigUintApproxSignedBasis(base, log_basis)
    plan = build_dcrt_plan64(log_n, moduli)
    level = basis.decompose_length
    k1 = 2
    rng = np.random.default_rng(7)
    q0 = min(moduli)
    bsk = to_u64_pair(rng.integers(
        0, q0, size=(n_lwe, k1, level, 2, k1, n), dtype=np.uint64))
    acc = to_u64_pair(rng.integers(
        0, q0, size=(batch, 2, k1, n), dtype=np.uint64))
    lwe = jnp.asarray(
        rng.integers(0, 2 * n, size=(batch, n_lwe + 1)).astype(np.int32))
    return base, basis, plan, bsk, acc, lwe


@pytest.mark.parametrize("log_n,n_lwe,batch,moduli", [
    (5, 4, 8, MODULI),
    (8, 2, 8, MODULI),
    (8, 2, 8, MODULI60),
])
def test_sharded_rotation_bit_exact(log_n, n_lwe, batch, moduli):
    base, basis, plan, bsk, acc, lwe = _setup(log_n, n_lwe, batch,
                                              moduli=moduli)
    want = dcrt_blind_rotate_batched(plan, basis, base, bsk, lwe, acc)

    mesh = make_mesh(8, residue=2)
    fn = make_sharded_blind_rotation(
        mesh, "residue", "batch", basis, plan, base
    )
    sb, sl, sa = shard_rotation_inputs(mesh, "residue", "batch", bsk, lwe, acc)
    got = fn(sb, sl, sa)
    assert (np.asarray(got.lo) == np.asarray(want.lo)).all()
    assert (np.asarray(got.hi) == np.asarray(want.hi)).all()


def test_sharded_rotation_collective_structure():
    """Only the CRT-compose collectives (reduce-scatter + all-gather
    pairs), inside the scan — no permutes; the batch axis stays
    collective-free."""
    import re

    base, basis, plan, bsk, acc, lwe = _setup(5, 4, 8)
    mesh = make_mesh(8, residue=2)
    fn = make_sharded_blind_rotation(
        mesh, "residue", "batch", basis, plan, base
    )
    sb, sl, sa = shard_rotation_inputs(mesh, "residue", "batch", bsk, lwe, acc)
    txt = fn.compiled.lower(
        sb.lo, sb.hi, sl, sa.lo, sa.hi,
        base.modulus, base.inv_punctured,
        base.punctured_limbs, base.punctured_limbs_shift,
        *jax.tree.flatten(plan)[0],
    ).compile().as_text()
    n_rs = len(re.findall(r"\breduce-scatter\b", txt))
    n_ag = len(re.findall(r"\ball-gather\b", txt))
    assert n_rs >= 1 and n_ag >= 1, (n_rs, n_ag)
    assert "collective-permute" not in txt
