"""Base58 decode, for the program ids the pack cost model keys on.

A copy of firedancer_tpu/ballet/base58.py trimmed to `decode` and
`decode_32` (ballet/pack.py decodes the Vote program id,
ballet/compute_budget.py the builtin program ids).

Behavior contract: src/ballet/base58/ (the reference has dedicated 32- and
64-byte paths because validator hot paths only ever encode pubkeys and
signatures).  Host-side: base58 is never on the packet hot path.
"""

from __future__ import annotations

import numpy as np

ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INV = np.full(128, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _INV[_c] = _i


def decode(s: str | bytes, expected_len: int | None = None) -> bytes | None:
    """Generic base58 decode; None on bad char or length mismatch."""
    if isinstance(s, str):
        s = s.encode()
    if not s:
        return None if expected_len not in (None, 0) else b""
    num = 0
    for ch in s:
        if ch >= 128 or _INV[ch] < 0:
            return None
        num = num * 58 + int(_INV[ch])
    n_ones = len(s) - len(bytes(s).lstrip(b"1"))
    body = num.to_bytes((num.bit_length() + 7) // 8, "big")
    out = b"\0" * n_ones + body
    if expected_len is not None and len(out) != expected_len:
        return None
    return out


def decode_32(s: str | bytes) -> bytes | None:
    return decode(s, 32)
