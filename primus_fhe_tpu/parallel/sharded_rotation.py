"""Explicit shard_map DCRT blind rotation — the production multi-chip step.

`__graft_entry__`'s MULTICHIP step previously relied on auto-SPMD over
``dcrt_blind_rotate_batched``; this module is the explicit version on a
``(residue, batch)`` mesh, built from the same pieces as the overlapped
gadget product (:mod:`.overlap`):

* batch axis: pure data parallel — zero collectives;
* residue axis: the ONE cross-residue contraction (CRT compose) runs as
  the packed-floor reduce-scatter + sharded carry-walk + packed
  all-gather of :func:`.overlap._psum_bigint` (W-bit limbs in u32
  lanes, W = 32 - ceil(log2 D) — the scatter payload is the packed
  size), issued per GLWE component ahead of the level compute;
* per-residue NTTs (the inverse bringing the CMux diff to coefficients
  and the forward per gadget digit) run on each device's residue slice
  of the plan tables — zero communication.

Bit-identical to :func:`..boot.dcrt_blind_rotate.dcrt_blind_rotate_batched`
(tests/test_sharded_rotation.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..modular.modops import add64, mul64, sub64
from ..numeric.bigint import big_from_int
from ..numeric.limb import U64
from ..transforms.dcrt import dcrt_forward64, dcrt_inverse64, dcrt_monomial64
from .overlap import _make_gadget_local

_U32 = jnp.uint32


def make_sharded_blind_rotation(
    mesh: Mesh,
    r_axis: str,
    b_axis: str,
    basis,  # BigUintApproxSignedBasis
    plan,  # DcrtPlan64
    rns_base,  # RNSBase64
):
    """Builds ``fn(bsk, lwe, acc) -> U64`` with the layouts of
    ``dcrt_blind_rotate_batched``: ``bsk (n_lwe, k+1, L, n_mod, k+1, N)``
    residue-sharded on dim 3, ``lwe (B, n_lwe+1)`` batch-sharded,
    ``acc (B, n_mod, k+1, N)`` batch- and residue-sharded.  Hold the
    returned fn — it owns the compiled SPMD program."""
    d = mesh.shape[r_axis]
    n_mod = rns_base.count
    assert n_mod % d == 0
    m_loc = n_mod // d
    L = rns_base.big_len
    level = basis.decompose_length
    small_mod = int(basis.basis)
    q_prod = rns_base.q_product
    log_d = max(0, d.bit_length() - 1)
    q_multiples = [
        jnp.asarray(big_from_int((1 << j) * q_prod, L + 1))
        for j in range(log_d - 1, -1, -1)
    ] or [jnp.asarray(big_from_int(q_prod, L + 1))]
    q_ext = jnp.asarray(big_from_int(q_prod, L + 1))
    half = (small_mod + 1) // 2
    half_u = U64(_U32(half & 0xFFFFFFFF), _U32((half >> 32) & 0xFFFFFFFF))
    sm_u = U64(_U32(small_mod & 0xFFFFFFFF), _U32((small_mod >> 32) & 0xFFFFFFFF))

    plan_leaves, plan_def = jax.tree.flatten(plan)
    mono_ids = {id(plan.monomial_base)}
    plan_specs = tuple(
        P(None) if id(leaf) in mono_ids else P(r_axis, *([None] * (leaf.ndim - 1)))
        for leaf in plan_leaves
    )
    gadget_local = _make_gadget_local(
        r_axis, basis, plan_def, m_loc, L, level, small_mod,
        q_multiples, q_ext, half_u, sm_u, q_bits=q_prod.bit_length(),
    )

    def local_fn(blo, bhi, lwe, alo, ahi, mod, ipf, p_limbs, p_shift, *leaves):
        local_plan = jax.tree.unflatten(plan_def, leaves)
        n_lwe = blo.shape[0]
        n = plan.n
        # residue-major internal layout (m_loc, B_loc, k1, N)
        acc = U64(jnp.swapaxes(alo, 0, 1), jnp.swapaxes(ahi, 0, 1))
        m4 = jax.tree.map(lambda x: x.reshape(m_loc, 1, 1, 1), mod)

        b = lwe[:, n_lwe]
        mono_b = dcrt_monomial64(local_plan, ((-b) % (2 * n))[:, None])
        mb = U64(mono_b.lo[:, :, None, :], mono_b.hi[:, :, None, :])
        acc = mul64(acc, mb, m4)

        gadget_b = jax.vmap(
            gadget_local,
            in_axes=(1, 1, None, None, None, None, None, None, None),
            out_axes=(1, 1),
        )

        def body(acc, x):
            a_i, bl_i, bh_i = x  # a_i (B_loc,)
            mono = dcrt_monomial64(local_plan, (a_i % (2 * n))[:, None])
            mo = U64(mono.lo[:, :, None, :], mono.hi[:, :, None, :])
            rotated = mul64(acc, mo, m4)
            diff_ntt = sub64(rotated, acc, m4.value)
            diff = dcrt_inverse64(local_plan, diff_ntt)  # (m_loc, B_loc, k1, N)
            dlo, dhi = gadget_b(
                diff.lo, diff.hi, bl_i, bh_i, mod, ipf, p_limbs, p_shift, leaves
            )
            return add64(acc, U64(dlo, dhi), m4.value), None

        a_t = jnp.swapaxes(lwe[:, :n_lwe], 0, 1)  # (n_lwe, B_loc)
        acc, _ = jax.lax.scan(body, acc, (a_t, blo, bhi))
        return jnp.swapaxes(acc.lo, 0, 1), jnp.swapaxes(acc.hi, 0, 1)

    sp_b = P(None, None, None, r_axis, None, None)
    sp_l = P(b_axis, None)
    sp_a = P(b_axis, r_axis, None, None)
    sp_1 = P(r_axis)
    sp_2 = P(r_axis, None)
    fn = jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(
                sp_b, sp_b, sp_l, sp_a, sp_a,
                jax.tree.map(lambda _: sp_1, rns_base.modulus),
                jax.tree.map(lambda _: sp_1, rns_base.inv_punctured),
                sp_2, sp_2,
            ) + plan_specs,
            out_specs=(sp_a, sp_a),
            check_vma=False,
        )
    )

    def run(bsk: U64, lwe, acc: U64) -> U64:
        lo, hi = fn(
            bsk.lo, bsk.hi, lwe, acc.lo, acc.hi,
            rns_base.modulus, rns_base.inv_punctured,
            rns_base.punctured_limbs, rns_base.punctured_limbs_shift,
            *plan_leaves,
        )
        return U64(lo, hi)

    run.compiled = fn
    return run


def shard_rotation_inputs(mesh: Mesh, r_axis: str, b_axis: str, bsk: U64,
                          lwe, acc: U64):
    """Places the rotation operands onto the mesh."""
    sh_b = NamedSharding(mesh, P(None, None, None, r_axis, None, None))
    sh_l = NamedSharding(mesh, P(b_axis, None))
    sh_a = NamedSharding(mesh, P(b_axis, r_axis, None, None))
    return (
        jax.tree.map(lambda x: jax.device_put(x, sh_b), bsk),
        jax.device_put(lwe, sh_l),
        jax.tree.map(lambda x: jax.device_put(x, sh_a), acc),
    )
