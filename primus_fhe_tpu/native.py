"""ctypes bindings for the native host kernels (``native/primus_native.cpp``).

The C++ library provides exact u64 modular arithmetic and the negacyclic
NTT with conventions identical to the device path, plus fast root search
and table fills at large n.  It is a second, independent golden oracle
for the differential test suites (Python ints ↔ C++ u128 ↔ jnp limbs must
all agree bit-exactly); the library's device path never imports it.

The shared object is built on demand with ``make`` (g++, no deps) and
cached next to the source.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_SO = _NATIVE_DIR / "libprimus_native.so"

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _SO.exists():
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(_SO))
    u64 = ctypes.c_uint64
    p64 = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    lib.primus_minimal_primitive_root.restype = u64
    lib.primus_minimal_primitive_root.argtypes = [ctypes.c_uint, u64]
    lib.primus_mod_inv.restype = u64
    lib.primus_mod_inv.argtypes = [u64, u64]
    lib.primus_mulmod.restype = u64
    lib.primus_mulmod.argtypes = [u64, u64, u64]
    lib.primus_powmod.restype = u64
    lib.primus_powmod.argtypes = [u64, u64, u64]
    lib.primus_shoup_quot.restype = u64
    lib.primus_shoup_quot.argtypes = [u64, u64]
    lib.primus_build_tables.restype = ctypes.c_int
    lib.primus_build_tables.argtypes = [ctypes.c_uint, u64] + [p64] * 6
    lib.primus_forward_ntt.restype = None
    lib.primus_forward_ntt.argtypes = [ctypes.c_uint, u64, p64, p64, p64]
    lib.primus_inverse_ntt.restype = None
    lib.primus_inverse_ntt.argtypes = [ctypes.c_uint, u64, p64, p64, p64, p64]
    lib.primus_negacyclic_mul.restype = None
    lib.primus_negacyclic_mul.argtypes = [ctypes.c_uint, u64] + [p64] * 8
    _lib = lib
    return lib


class NativeNtt:
    """Native NTT tables + transforms for one (log_n, q)."""

    def __init__(self, log_n: int, q: int):
        lib = _load()
        self.log_n = log_n
        self.n = n = 1 << log_n
        self.q = q
        self.roots = np.zeros(n, dtype=np.uint64)
        self.roots_q = np.zeros(n, dtype=np.uint64)
        self.inv_roots = np.zeros(n, dtype=np.uint64)
        self.inv_roots_q = np.zeros(n, dtype=np.uint64)
        self.ordinal = np.zeros(2 * n, dtype=np.uint64)
        self.consts = np.zeros(4, dtype=np.uint64)
        rc = lib.primus_build_tables(
            log_n, q, self.roots, self.roots_q, self.inv_roots,
            self.inv_roots_q, self.ordinal, self.consts,
        )
        if rc != 0:
            raise ValueError(f"native table build failed (rc={rc}) for q={q}")

    def forward(self, values: np.ndarray) -> np.ndarray:
        lib = _load()
        v = np.array(values, dtype=np.uint64)
        flat = v.reshape(-1, self.n)
        for row in flat:
            lib.primus_forward_ntt(self.log_n, self.q, self.roots, self.roots_q, row)
        return flat.reshape(v.shape)

    def inverse(self, values: np.ndarray) -> np.ndarray:
        lib = _load()
        v = np.array(values, dtype=np.uint64)
        flat = v.reshape(-1, self.n)
        for row in flat:
            lib.primus_inverse_ntt(
                self.log_n, self.q, self.inv_roots, self.inv_roots_q, self.consts, row
            )
        return flat.reshape(v.shape)

    def negacyclic_mul(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        lib = _load()
        aa = np.array(a, dtype=np.uint64)
        bb = np.array(b, dtype=np.uint64)
        out = np.zeros(self.n, dtype=np.uint64)
        lib.primus_negacyclic_mul(
            self.log_n, self.q, self.roots, self.roots_q, self.inv_roots,
            self.inv_roots_q, self.consts, aa, bb, out,
        )
        return out


def minimal_primitive_root(log_degree: int, q: int) -> int:
    root = _load().primus_minimal_primitive_root(log_degree, q)
    if root == 0:
        raise ValueError(f"no primitive 2^{log_degree}-th root modulo {q}")
    return int(root)


def mod_inv(a: int, q: int) -> int:
    inv = _load().primus_mod_inv(a, q)
    if inv == 0:
        raise ValueError(f"{a} not invertible mod {q}")
    return int(inv)
