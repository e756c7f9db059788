"""Base58 encode/decode with fixed-size paths.

A copy of firedancer_tpu/ballet/base58.py: the pack cost model decodes
program ids with it, RPC and the runtime encode and decode pubkeys.

Behavior contract: src/ballet/base58/ (reference has dedicated 32- and
64-byte paths because validator hot paths only ever encode pubkeys and
signatures).  Host-side: base58 is used for logs/RPC/keys, never on the
packet hot path.
"""

from __future__ import annotations

import numpy as np

ALPHABET = b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_INV = np.full(128, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _INV[_c] = _i

#: encoded lengths of the fixed paths (reference: FD_BASE58_ENCODED_32_SZ=45,
#: FD_BASE58_ENCODED_64_SZ=89 include the NUL; lengths here are max chars)
ENCODED_32_MAX = 44
ENCODED_64_MAX = 88


def encode(data: bytes) -> str:
    """Generic base58 encode (big-endian base conversion)."""
    n_zeros = len(data) - len(data.lstrip(b"\0"))
    num = int.from_bytes(data, "big")
    out = bytearray()
    while num:
        num, rem = divmod(num, 58)
        out.append(ALPHABET[rem])
    out += b"1" * n_zeros
    return bytes(reversed(out)).decode()

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


def encode_32(data: bytes) -> str:
    """Pubkey path (reference: fd_base58_encode_32)."""
    assert len(data) == 32
    return encode(data)


def encode_64(data: bytes) -> str:
    """Signature path (reference: fd_base58_encode_64)."""
    assert len(data) == 64
    return encode(data)


def decode_32(s: str | bytes) -> bytes | None:
    return decode(s, 32)


def decode_64(s: str | bytes) -> bytes | None:
    return decode(s, 64)
