"""Extended GCD and modular inverses over Python integers.

Plays the role of ``primus_gcd`` (reference: ``crates/primus_gcd/src/lib.rs``,
``Xgcd`` trait at lib.rs:28-166, Hensel ``INV_TABLE`` at lib.rs:17).  Here all
of this runs at *plan time* on the host: table construction and
parameter derivation need a handful of inverses, never the device.  Arbitrary-
precision Python integers make the branch-free Rust bit tricks unnecessary —
the contracts (Bezout identity, gcd normalization, pow-2 Hensel lifting) are
preserved and tested exhaustively for small widths like the reference does.
"""

from __future__ import annotations


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended Euclid: returns ``(g, x, y)`` with ``a*x + b*y == g = gcd(a, b)``.

    Both inputs must be non-negative.
    """
    if a < 0 or b < 0:
        raise ValueError("xgcd expects non-negative inputs")
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r != 0:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    return old_r, old_s, old_t


def gcdinv(a: int, m: int) -> tuple[int, int]:
    """Returns ``(inv, g)`` where ``g = gcd(a, m)`` and ``inv * a ≡ g (mod m)``,
    with ``0 <= inv < m`` — the contract of the reference's ``Xgcd::gcdinv``.
    """
    if m <= 0:
        raise ValueError("modulus must be positive")
    g, x, _ = xgcd(a % m, m)
    return x % m, g


def mod_inv(a: int, m: int) -> int:
    """Modular inverse ``a^-1 mod m``; raises if not invertible.

    Mirrors ``mod_inv`` in the reference NTT table construction
    (``crates/primus_ntt/src/ntt/prime64/table.rs:119-124``).
    """
    inv, g = gcdinv(a, m)
    if g != 1:
        raise ValueError(f"{a} is not invertible modulo {m}")
    return inv


def hensel_inv_pow2(a: int, k: int) -> int:
    """Inverse of odd ``a`` modulo ``2^k`` via Hensel / Newton lifting.

    The reference seeds from a 128-entry byte table and doubles precision per
    step (``crates/primus_gcd/src/lib.rs``); the same quadratic lift is used
    here starting from the trivial 1-bit inverse.
    """
    if a % 2 == 0:
        raise ValueError("only odd values are invertible modulo 2^k")
    if k <= 0:
        raise ValueError("k must be positive")
    mask = (1 << k) - 1
    x = 1  # inverse mod 2
    bits = 1
    while bits < k:
        bits *= 2
        x = (x * (2 - a * x)) & ((1 << min(bits, k)) - 1)
    return x & mask
