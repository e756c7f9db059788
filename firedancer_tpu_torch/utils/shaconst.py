"""SHA-512 round constants, derived (not pasted): K[i] is the fractional
part of the cube root of the i-th prime, H0[i] of the square root, per
FIPS 180-4.

A copy of the SHA-512 half of firedancer_tpu/utils/shaconst.py, kept in the
port so that firedancer_tpu_torch imports nothing of the JAX package."""

from __future__ import annotations

import math


def _icbrt(n: int) -> int:
    x = 1 << ((n.bit_length() + 2) // 3 + 1)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            return x
        x = y


def _primes(n: int) -> list[int]:
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps):
            ps.append(c)
        c += 1
    return ps


def gen_sha512_constants() -> tuple[list[int], list[int]]:
    ps = _primes(80)
    k = [_icbrt(p << 192) & ((1 << 64) - 1) for p in ps]
    h = [math.isqrt(p << 128) & ((1 << 64) - 1) for p in ps[:8]]
    return k, h


K64, H64 = gen_sha512_constants()
assert K64[0] == 0x428A2F98D728AE22 and H64[0] == 0x6A09E667F3BCC908
