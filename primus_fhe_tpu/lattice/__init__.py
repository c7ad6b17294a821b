"""Lattice ciphertext layer: containers as shape conventions + composite ops.

The reference generates its container grid with 14 macros over flat buffers
(``crates/primus_lattice/src/macros/mod.rs``); the analogue here is a
*layout convention* over jnp arrays — no wrapper types to fight the pytree
machinery:

=============  ============================  ==========================================
container      layout (uint32 / U64)         reference
=============  ============================  ==========================================
LWE            ``(..., n+1)`` = |a…|b|        ``src/lwe/single_message.rs:14``
MultiMsgLWE    ``(..., n+count)``             ``src/lwe/multiple_message.rs:14``
RLWE           ``(..., 2, N)`` = [a; b]       ``src/rlwe/coeff.rs:26``
GLWE           ``(..., k+1, N)``              ``src/glwe/*.rs``
GLev           ``(..., L, k+1, N)``           ``src/glev/mod.rs``
GGSW           ``(..., k+1, L, k+1, N)``      ``src/ggsw/mod.rs``
RLev / RGSW    GLev / GGSW with k = 1         ``src/{rlev,rgsw}/mod.rs``
NTRU           ``(..., N)``                   ``src/ntru/mod.rs``
CRT variants   leading ``(n_mod,)`` axis      ``src/*/crt.rs`` (modulus-major)
NTT variants   same shape, evaluation domain  ``src/*/ntt.rs`` (bit-reversed order)
=============  ============================  ==========================================
"""

from . import dcrt, glev, glwe, keyswitch, lwe, ntru, rlwe, tfhe

__all__ = [
    "dcrt",
    "glev",
    "glwe",
    "keyswitch",
    "lwe",
    "ntru",
    "rlwe",
    "tfhe",
]
