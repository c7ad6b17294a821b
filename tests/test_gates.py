"""Homomorphic boolean gates: full truth tables through the complete
bootstrap + key-switch loop (composability: outputs live under the input
key)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from primus_fhe_tpu.boot import make_bootstrap_key
from primus_fhe_tpu.boot.gates import (
    FALSE_MU,
    TRUE_MU,
    and_gate,
    nand_gate,
    not_gate,
    or_gate,
)
from primus_fhe_tpu.decompose import ApproxSignedBasis32
from primus_fhe_tpu.distr.sampling import DiscreteGaussian
from primus_fhe_tpu.lattice import keyswitch, tfhe
from primus_fhe_tpu.lattice.lwe import phase_torus32

pytestmark = pytest.mark.slow

LOG_N = 5
N = 1 << LOG_N
K = 1
N_LWE = 8


@pytest.fixture(scope="module")
def ctx():
    basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    ks_basis = ApproxSignedBasis32(None, 8, reverse_length=3)
    conv = tfhe.make_convolver(LOG_N, 3, K, 8)
    gauss = DiscreteGaussian(3.2)
    key = jax.random.PRNGKey(3)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    lwe_s = (jax.random.bits(k1, (N_LWE,), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    glwe_s = (jax.random.bits(k2, (K, N), dtype=jnp.uint32) & 1).astype(jnp.uint32)
    bsk = make_bootstrap_key(k3, lwe_s, glwe_s, basis, gauss, conv)
    ksk = keyswitch.make_keyswitch_key(k4, glwe_s.reshape(-1), lwe_s, ks_basis, gauss)
    return basis, ks_basis, conv, gauss, lwe_s, bsk, ksk


def _encrypt(key, bit, secret):
    mu = TRUE_MU if bit else FALSE_MU
    a = jax.random.bits(key, (N_LWE,), dtype=jnp.uint32)
    b = jnp.sum(a * secret, dtype=jnp.uint32) + jnp.uint32(mu)
    return jnp.concatenate([a, b[None]])


def _decrypt(ct, secret):
    ph = int(np.int64(np.asarray(phase_torus32(ct, secret), dtype=np.uint32)))
    centered = ph - (1 << 32) if ph >= 1 << 31 else ph
    return centered > 0


@pytest.mark.parametrize(
    "gate,table",
    [
        (nand_gate, {(0, 0): 1, (0, 1): 1, (1, 0): 1, (1, 1): 0}),
        (and_gate, {(0, 0): 0, (0, 1): 0, (1, 0): 0, (1, 1): 1}),
        (or_gate, {(0, 0): 0, (0, 1): 1, (1, 0): 1, (1, 1): 1}),
    ],
)
def test_gate_truth_table(ctx, gate, table):
    basis, ks_basis, conv, gauss, lwe_s, bsk, ksk = ctx
    key = jax.random.PRNGKey(9)
    for (b1, b2), expect in table.items():
        kk = jax.random.fold_in(key, b1 * 2 + b2)
        c1 = _encrypt(jax.random.fold_in(kk, 0), b1, lwe_s)
        c2 = _encrypt(jax.random.fold_in(kk, 1), b2, lwe_s)
        out = gate(conv, basis, bsk, ksk, ks_basis, c1, c2, LOG_N)
        assert out.shape == (N_LWE + 1,)
        assert _decrypt(out, lwe_s) == bool(expect), (b1, b2)


def test_not_gate(ctx):
    basis, ks_basis, conv, gauss, lwe_s, bsk, ksk = ctx
    key = jax.random.PRNGKey(10)
    for b in (0, 1):
        c = _encrypt(jax.random.fold_in(key, b), b, lwe_s)
        assert _decrypt(not_gate(c), lwe_s) == (not b)


def test_gate_composability(ctx):
    """Gate outputs feed gates: NAND(NAND(a,b), NAND(a,b)) == AND(a,b)."""
    basis, ks_basis, conv, gauss, lwe_s, bsk, ksk = ctx
    key = jax.random.PRNGKey(11)
    for b1, b2 in [(1, 1), (1, 0)]:
        c1 = _encrypt(jax.random.fold_in(key, 2 * b1 + b2), b1, lwe_s)
        c2 = _encrypt(jax.random.fold_in(key, 10 + 2 * b1 + b2), b2, lwe_s)
        nand = nand_gate(conv, basis, bsk, ksk, ks_basis, c1, c2, LOG_N)
        result = nand_gate(conv, basis, bsk, ksk, ks_basis, nand, nand, LOG_N)
        assert _decrypt(result, lwe_s) == bool(b1 and b2), (b1, b2)
