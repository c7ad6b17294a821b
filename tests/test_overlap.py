"""Overlapped sharded DCRT gadget product: bit-exact vs the single-device
path; compose collectives are per-component all-reduces issued ahead of
the level compute (the overlap structure of parallel/overlap.py)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.decompose import BigUintApproxSignedBasis
from primus_fhe_tpu.lattice.dcrt import crt_glwe_mul_dcrt_ggsw
from primus_fhe_tpu.numeric import from_u64_pair, to_u64_pair
from primus_fhe_tpu.parallel.mesh import make_mesh
from primus_fhe_tpu.parallel.overlap import (
    make_sharded_gadget_product,
    shard_gadget_inputs,
)
from primus_fhe_tpu.rns import RNSBase64
from primus_fhe_tpu.transforms.dcrt import build_dcrt_plan64

pytestmark = [
    pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices"),
    pytest.mark.slow,
]

MODULI = [1125899906826241, 1125899906629633]


def _setup(log_n=5, k1=2, log_basis=25):
    n = 1 << log_n
    base = RNSBase64(MODULI)
    basis = BigUintApproxSignedBasis(base, log_basis)
    plan = build_dcrt_plan64(log_n, MODULI)
    level = basis.decompose_length
    rng = np.random.default_rng(3)
    glwe = to_u64_pair(
        rng.integers(0, min(MODULI), size=(2, k1, n), dtype=np.uint64)
    )
    ggsw = to_u64_pair(
        rng.integers(0, min(MODULI), size=(k1, level, 2, k1, n), dtype=np.uint64)
    )
    return base, basis, plan, glwe, ggsw


@pytest.mark.parametrize("d,log_n", [(1, 5), (2, 5), (2, 8)])
def test_overlapped_gadget_product_bit_exact(d, log_n):
    base, basis, plan, glwe, ggsw = _setup(log_n=log_n)
    ref = crt_glwe_mul_dcrt_ggsw(glwe, ggsw, basis, plan, base)

    mesh = make_mesh(2 * d, residue=d)
    fn = make_sharded_gadget_product(mesh, "residue", basis, plan, base)
    sg, sk = shard_gadget_inputs(mesh, "residue", glwe, ggsw)
    out = fn(sg, sk)
    assert (from_u64_pair(out) == from_u64_pair(ref)).all()


def test_overlap_collective_structure():
    """k+1 compose collectives (one per component), now in the
    reduce-scatter + local-carry + all-gather form: the halves (2x
    packed bytes) ride only the scatter leg, the gather ships packed u32
    limbs (3S vs the all-reduce's 4S ring bytes), and the carry walk is
    sharded.  No collective-permute, no plain all-reduce."""
    base, basis, plan, glwe, ggsw = _setup()
    mesh = make_mesh(2, residue=2)
    fn = make_sharded_gadget_product(mesh, "residue", basis, plan, base)
    sg, sk = shard_gadget_inputs(mesh, "residue", glwe, ggsw)
    txt = fn.compiled.lower(
        sg.lo, sg.hi, sk.lo, sk.hi,
        base.modulus, base.inv_punctured,
        base.punctured_limbs, base.punctured_limbs_shift,
        *jax.tree.flatten(plan)[0],
    ).compile().as_text()
    k1 = glwe.lo.shape[-2]
    n_rs = len(re.findall(r"\breduce-scatter\b", txt))
    n_ag = len(re.findall(r"\ball-gather\b", txt))
    assert n_rs >= k1 and n_ag >= k1, (n_rs, n_ag)
    assert "collective-permute" not in txt and "all-to-all" not in txt
