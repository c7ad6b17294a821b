"""NTT plan construction (host-side, one-time — SURVEY.md §3.1).

Plays the role of ``U64NttTable::new`` / ``U32NttTable::new``
(``crates/primus_ntt/src/ntt/prime64/table.rs:305-420``): finds the minimal
primitive ``2n``-th root, builds bit-reversed forward/inverse root tables
with Shoup preconditioners, and the fused ``inv_n`` final-stage constants.
The result is a pytree of device arrays; ``log_n`` is static metadata so
stage loops unroll at trace time.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..golden.model import GoldenNtt
from ..numeric.limb import U64, to_u64_pair


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NttPlan32:
    """Root tables for the uint32 NTT path (``q < 2^30`` — lazy ``[0,4q)``)."""

    q: jnp.ndarray
    roots: jnp.ndarray  # (n,) bit-reversed psi powers
    roots_precon: jnp.ndarray  # (n,) Shoup 32-bit quotients
    inv_roots: jnp.ndarray
    inv_roots_precon: jnp.ndarray
    inv_n: jnp.ndarray
    inv_n_precon: jnp.ndarray
    inv_n_w: jnp.ndarray  # inv_n * inv_roots[n-1] mod q
    inv_n_w_precon: jnp.ndarray
    ordinal_roots: jnp.ndarray  # (2n,) psi^i for monomial transforms
    monomial_base: jnp.ndarray  # (n,) 2*reverse_lsbs[j] + 1
    log_n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return 1 << self.log_n


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NttPlan64:
    """Root tables for the U64-limb NTT path (``q < 2^62``)."""

    q: U64
    roots: U64
    roots_precon: U64  # Shoup 64-bit quotients
    inv_roots: U64
    inv_roots_precon: U64
    inv_n: U64
    inv_n_precon: U64
    inv_n_w: U64
    inv_n_w_precon: U64
    ordinal_roots: U64
    monomial_base: jnp.ndarray  # (n,) int32: 2*reverse_lsbs[j] + 1
    log_n: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return 1 << self.log_n


def _tables(log_n: int, q: int, root: int | None = None):
    g = GoldenNtt(log_n, q, root=root)
    n = g.n

    def quot32(w):
        return ((w << 32) // q) & 0xFFFFFFFF

    def quot64(w):
        return ((w << 64) // q) & 0xFFFFFFFFFFFFFFFF

    mono = np.array([2 * i + 1 for i in g.reverse_lsbs], dtype=np.int64)
    return g, n, quot32, quot64, mono


def build_plan32(log_n: int, q: int) -> NttPlan32:
    """Builds a uint32 NTT plan.  Requires prime ``q < 2^30``, ``q ≡ 1 mod 2n``."""
    if q >= 1 << 30:
        raise ValueError("NttPlan32 requires q < 2^30 for the [0,4q) lazy range")
    g, n, quot32, _, mono = _tables(log_n, q)

    def arr(vals):
        return jnp.asarray(np.array(vals, dtype=np.uint32))

    return NttPlan32(
        q=jnp.uint32(q),
        roots=arr(g.roots),
        roots_precon=arr([quot32(w) for w in g.roots]),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr([quot32(w) for w in g.inv_roots]),
        inv_n=jnp.uint32(g.inv_n),
        inv_n_precon=jnp.uint32(quot32(g.inv_n)),
        inv_n_w=jnp.uint32(g.inv_n_w),
        inv_n_w_precon=jnp.uint32(quot32(g.inv_n_w)),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=jnp.asarray(mono.astype(np.int32)),
        log_n=log_n,
    )


def build_plan64(log_n: int, q: int, root: int | None = None) -> NttPlan64:
    """Builds a U64 NTT plan.  Requires prime ``q < 2^62``, ``q ≡ 1 mod 2n``.

    ``root`` overrides the minimal primitive ``2n``-th root (four-step
    sub-transforms take powers of their parent's root)."""
    if q >= 1 << 62:
        raise ValueError("NttPlan64 requires q < 2^62 for the [0,4q) lazy range")
    g, n, _, quot64, mono = _tables(log_n, q, root)

    def arr(vals):
        return to_u64_pair(np.array(vals, dtype=np.uint64))

    return NttPlan64(
        q=to_u64_pair(np.uint64(q)),
        roots=arr(g.roots),
        roots_precon=arr([quot64(w) for w in g.roots]),
        inv_roots=arr(g.inv_roots),
        inv_roots_precon=arr([quot64(w) for w in g.inv_roots]),
        inv_n=to_u64_pair(np.uint64(g.inv_n)),
        inv_n_precon=to_u64_pair(np.uint64(quot64(g.inv_n))),
        inv_n_w=to_u64_pair(np.uint64(g.inv_n_w)),
        inv_n_w_precon=to_u64_pair(np.uint64(quot64(g.inv_n_w))),
        ordinal_roots=arr(g.ordinal_roots),
        monomial_base=jnp.asarray(mono.astype(np.int32)),
        log_n=log_n,
    )
