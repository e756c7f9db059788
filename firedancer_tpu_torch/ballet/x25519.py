"""X25519 Diffie-Hellman (RFC 7748), host-side python-int Montgomery ladder.

A copy of firedancer_tpu/ballet/x25519.py.

The reference keeps X25519 beside Ed25519 (src/ballet/
ed25519/fd_x25519.c, behavior contract only).  Here it serves the TLS 1.3
handshake — control-plane work at handshake rates, so a constant-structure
(single fixed ladder, no data-dependent branches at the group level)
python-int implementation is the right tool; the batch TPU field kernels
are reserved for the verify data plane.
"""

from __future__ import annotations

P = 2**255 - 19
_A24 = 121665
BASE_POINT = (9).to_bytes(32, "little")


def _decode_scalar(k: bytes) -> int:
    assert len(k) == 32
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(bytes(b), "little")


def _decode_u(u: bytes) -> int:
    assert len(u) == 32
    n = int.from_bytes(u, "little")
    return (n & ((1 << 255) - 1)) % P


def x25519(k: bytes, u: bytes) -> bytes:
    """Scalar-multiply: shared = k * u.  Returns 32-byte u-coordinate."""
    k_int = _decode_scalar(k)
    x1 = _decode_u(u)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in range(254, -1, -1):
        k_t = (k_int >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * ((aa + _A24 * e) % P) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


def public_key(secret: bytes) -> bytes:
    return x25519(secret, BASE_POINT)
