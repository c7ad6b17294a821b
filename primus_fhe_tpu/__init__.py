"""primus-fhe-tpu: an exact-integer lattice-FHE primitive framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of
``primus-labs/primus-fhe`` (see ``SURVEY.md``): exact limb-decomposed modular
integer arithmetic (Barrett/Shoup lazy reduction), negacyclic NTT/INTT over
32/62-bit primes, torus negacyclic transforms, RNS multi-modulus polynomial
rings with fast basis conversion, approximate signed gadget decomposition,
FHE noise samplers, and lattice ciphertext operations (LWE/RLWE/GLWE/GLev/
GGSW/RGSW/NTRU, TFHE external product, LWE sample extraction) composing into
a blind-rotation bootstrapping pipeline sharded over a device mesh.

Layer map (mirrors SURVEY.md section 1, re-designed for JAX):

====================  =========================================  ==================
this package          role                                       reference crate
====================  =========================================  ==================
``utils.gcd``         xgcd / gcdinv / Hensel pow-2 inverse       primus_gcd
``numeric.limb``      u32-limb widening/carrying mul kernels     primus_integer
``numeric.bigint``    little-endian limb big integers            primus_integer
``modular``           modulus types + functional mod-op ns       primus_reduce,
                                                                 primus_modulo,
                                                                 primus_modulus,
                                                                 primus_factor
``distr``             binary/ternary/discrete-Gaussian samplers  primus_distr
``poly``              polynomial representations                 primus_poly
``transforms``        negacyclic NTT / DCRT / torus transforms   primus_ntt,
                                                                 primus_fft
``rns``               RNS basis + fast base conversion           primus_rns
``decompose``         approximate signed gadget decomposition    primus_decompose
``lattice``           ciphertext containers + composite ops      primus_lattice
``parallel``          mesh sharding / collectives                (new)
``boot``              blind-rotation bootstrapping pipeline      (new; composed)
====================  =========================================  ==================

Unlike the reference (single-thread Rust + AVX), every hot path here is a
JAX program that XLA compiles for the device: elementwise u32 limb
arithmetic, staged NTT butterflies, and RNS-residue/coefficient sharding
over a ``jax.sharding.Mesh``.
Deterministic integer semantics are preserved end-to-end: no float drift,
bit-exact against the reference's conventions.
"""

__version__ = "0.1.0"

from . import utils  # noqa: F401
