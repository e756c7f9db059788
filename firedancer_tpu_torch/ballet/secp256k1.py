"""secp256k1 public-key recovery — the secp256k1 precompile's core.

A copy of firedancer_tpu/ballet/secp256k1.py.

Behavior contract: the reference vendors libsecp256k1 under
src/ballet/secp256k1/ and exposes fd_secp256k1_recover (pubkey recovery
from a 32-byte digest + 64-byte signature + recovery id), consumed by
the Keccak-Secp256k1 native program and the sol_secp256k1_recover
syscall.  This build needs correctness at precompile-instruction rates
(a handful per txn), not bulk throughput, so the curve math is direct
affine arithmetic over python ints; the batch-verify hot path stays
ed25519-on-TPU.
"""

from __future__ import annotations

# curve: y^2 = x^3 + 7 over F_P, group order N
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _add(p1, p2):
    """Affine point addition; None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        m = (3 * x1 * x1) * pow(2 * y1, P - 2, P) % P
    else:
        m = (y2 - y1) * pow(x2 - x1, P - 2, P) % P
    x3 = (m * m - x1 - x2) % P
    return (x3, (m * (x1 - x3) - y1) % P)


def _mul(k: int, pt):
    acc = None
    while k:
        if k & 1:
            acc = _add(acc, pt)
        pt = _add(pt, pt)
        k >>= 1
    return acc


def _lift_x(x: int, odd: bool):
    """Point with the given x and y parity, or None if x is not on the
    curve."""
    if x >= P:
        return None
    ysq = (pow(x, 3, P) + 7) % P
    y = pow(ysq, (P + 1) // 4, P)
    if y * y % P != ysq:
        return None
    if (y & 1) != odd:
        y = P - y
    return (x, y)


def recover(digest: bytes, sig: bytes, recid: int):
    """Recover the signing public key -> 64-byte x||y, or None.

    digest: the 32-byte message hash; sig: r(32) || s(32) big-endian;
    recid: 0..3 (bit 0 = R.y parity, bit 1 = R.x overflowed the order).
    Standard ECDSA recovery: Q = r^-1 (s*R - e*G).
    """
    if len(digest) != 32 or len(sig) != 64 or not 0 <= recid <= 3:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return None
    x = r + (recid >> 1) * N
    R = _lift_x(x, bool(recid & 1))
    if R is None:
        return None
    e = int.from_bytes(digest, "big") % N
    rinv = pow(r, N - 2, N)
    neg_eg = _mul((N - e) % N, G)
    q = _mul(rinv, _add(_mul(s, R), neg_eg))
    if q is None:
        return None
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def sign(digest: bytes, secret: int, k: int):
    """Deterministic-k test helper -> (sig64, recid).  NOT a hardened
    signer (no RFC 6979): exists so the precompile tests can mint valid
    signatures without a second library."""
    R = _mul(k, G)
    r = R[0] % N
    s = pow(k, N - 2, N) * (
        (int.from_bytes(digest, "big") % N + r * secret) % N
    ) % N
    recid = (R[1] & 1) | (2 if R[0] >= N else 0)
    if s > N // 2:  # low-s normalization flips the recovery parity
        s = N - s
        recid ^= 1
    return (
        r.to_bytes(32, "big") + s.to_bytes(32, "big"),
        recid,
    )


def pubkey_of(secret: int) -> bytes:
    q = _mul(secret, G)
    return q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def eth_address(pubkey64: bytes) -> bytes:
    """keccak256(x || y)[12:] — the 20-byte address the precompile
    compares against."""
    from ..ops.keccak256 import digest_host

    return digest_host(pubkey64)[12:]
