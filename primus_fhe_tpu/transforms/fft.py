"""Torus negacyclic FFT — float reference backend.

Reference: ``crates/primus_fft/src/complex64/table.rs`` — the
``FullComplex64FftTable``: center to signed, twist by ``psi^j = e^{i pi j/N}``,
N-point FFT; inverse = IFFT, conj-twist/N, round-wrap
(``table.rs:98-130``), with the documented >2^53 precision caveat
(``src/torus.rs:20-58``).

Role here: **test oracle and CPU compatibility only.**  The float path
rounds; the production transform is
the exact integer CRT-NTT (:mod:`.torus`).  This backend is therefore
implemented host-side in NumPy (complex128 — one rounding better than the
reference's f64 path, differences bounded by the same analysis), used to
cross-check the exact path and to mirror the reference's semantics for
users porting code.
"""

from __future__ import annotations

import numpy as np


class Complex128FftTable:
    """Full-length negacyclic FFT over complex128 (host-side)."""

    def __init__(self, log_n: int):
        if log_n >= 60:
            raise ValueError(f"invalid log_n {log_n}")
        self.log_n = log_n
        self.poly_length = n = 1 << log_n
        self.fourier_length = n
        j = np.arange(n)
        # cis(pi*j/n): single rounding per element (table.rs:63-70)
        self.twist = np.exp(1j * np.pi * j / n)
        self.inv_twist_scaled = np.exp(-1j * np.pi * j / n) / n

    # -- torus conversions (torus.rs) --------------------------------------

    @staticmethod
    def _centered32(x: np.ndarray) -> np.ndarray:
        return x.astype(np.uint32).astype(np.int32).astype(np.float64)

    @staticmethod
    def _centered64(x: np.ndarray) -> np.ndarray:
        # WARNING: >2^53 loses precision, as in the reference (torus.rs:46)
        return x.astype(np.uint64).astype(np.int64).astype(np.float64)

    @staticmethod
    def _wrap_rounded32(v: np.ndarray) -> np.ndarray:
        return np.round(v).astype(np.int64).astype(np.uint32)

    @staticmethod
    def _wrap_rounded64(v: np.ndarray) -> np.ndarray:
        out = np.empty(v.shape, dtype=np.uint64)
        flat = np.round(v).ravel()
        of = out.ravel()
        for i, val in enumerate(flat):  # i128-equivalent wrap (torus.rs:56)
            of[i] = int(val) % (1 << 64)
        return out

    # -- transforms ---------------------------------------------------------

    def forward_torus(self, values: np.ndarray, bits: int = 32) -> np.ndarray:
        """Torus ints ``(..., N)`` -> Fourier complex128 ``(..., N)``."""
        centered = self._centered32(values) if bits == 32 else self._centered64(values)
        return np.fft.fft(centered * self.twist, axis=-1)

    def inverse_torus(self, values: np.ndarray, bits: int = 32) -> np.ndarray:
        """Fourier complex128 -> torus ints (round + wrap)."""
        buf = np.fft.ifft(values, axis=-1) * self.poly_length  # unscaled IFFT
        v = (buf * self.inv_twist_scaled).real
        return self._wrap_rounded32(v) if bits == 32 else self._wrap_rounded64(v)

    def negacyclic_mul(self, a: np.ndarray, b: np.ndarray, bits: int = 32) -> np.ndarray:
        """Float-path negacyclic product (rounding noise ~ the reference's)."""
        fa = self.forward_torus(a, bits)
        fb = self.forward_torus(b, bits)
        return self.inverse_torus(fa * fb, bits)
