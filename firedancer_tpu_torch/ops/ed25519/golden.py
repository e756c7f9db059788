"""Pure-Python Ed25519 reference ("golden") implementation.

A copy of firedancer_tpu/ops/ed25519/golden.py, kept in the port so that
firedancer_tpu_torch imports nothing of the JAX package.  It is the
bit-exact oracle for the port's verify path and the generator of its
base-point tables.  Semantics match the reference validator's verify rules
(fd_ed25519_user.c:134-229, independently re-implemented from RFC 8032):

  1. s must be canonical: 0 <= s < L           (else ERR_SIG)
  2. A and R must decompress                   (else ERR_PUBKEY / ERR_SIG);
     non-canonical y encodings (y >= p) are ACCEPTED (dalek 2.x behavior)
  3. A and R must not be small order           (else ERR_PUBKEY / ERR_SIG)
  4. k = SHA512(R || A || M) mod L
  5. cofactorless check: [S]B == R + [k]A, computed as
     Rcmp = [k](-A) + [S]B, compared against decompressed R (z=1)

Everything is plain-int math: slow, but unambiguous.
"""

from __future__ import annotations

import hashlib

# ---------------------------------------------------------------------------
# Field GF(p), p = 2^255 - 19
# ---------------------------------------------------------------------------

P = 2**255 - 19
# Edwards curve constant d = -121665/121666 mod p
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Group order L = 2^252 + 27742317777372353535851937790883648493
L = 2**252 + 27742317777372353535851937790883648493

ERR_OK = 0
ERR_SIG = -1
ERR_PUBKEY = -2
ERR_MSG = -3


def _inv(x: int) -> int:
    return pow(x, P - 2, P)


# ---------------------------------------------------------------------------
# Points: affine tuples (x, y); None is never used — identity is (0, 1).
# ---------------------------------------------------------------------------

IDENT = (0, 1)


def point_add(p1, p2):
    """Complete twisted-Edwards addition (affine, a = -1)."""
    x1, y1 = p1
    x2, y2 = p2
    dxxyy = D * x1 * x2 % P * y1 * y2 % P
    x3 = (x1 * y2 + x2 * y1) * _inv(1 + dxxyy) % P
    y3 = (y1 * y2 + x1 * x2) * _inv(1 - dxxyy) % P
    return (x3, y3)


def point_neg(p):
    x, y = p
    return ((-x) % P, y)


def scalar_mul(k: int, p) -> tuple:
    q = IDENT
    while k:
        if k & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        k >>= 1
    return q


# Base point B
BY = 4 * _inv(5) % P
_bx2 = (BY * BY - 1) * _inv(D * BY * BY + 1) % P
BX = pow(_bx2, (P + 3) // 8, P)
if (BX * BX - _bx2) % P != 0:
    BX = BX * SQRT_M1 % P
if BX % 2 != 0:
    BX = P - BX
B = (BX, BY)


def point_compress(p) -> bytes:
    x, y = p
    return int.to_bytes(y | ((x & 1) << 255), 32, "little")


def point_decompress(s: bytes):
    """Decompress 32 bytes -> affine point, or None on failure.

    Accepts non-canonical y (y >= p), matching dalek 2.x / the reference.
    Rejects x == 0 with sign bit set ("negative zero").
    """
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    # x = u/v ^ ((p+3)/8) via the ref10 trick: x = u v^3 (u v^7)^((p-5)/8)
    x = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P, (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign == 1:
        return None
    if (x & 1) != sign:
        x = P - x
    return (x, y)


def is_small_order(p) -> bool:
    """True iff the point's order divides 8."""
    q = point_add(p, p)
    q = point_add(q, q)
    q = point_add(q, q)
    return q == IDENT


def small_order_blocklist() -> list[bytes]:
    """Every 32-byte encoding point_decompress accepts that decodes to a
    small-order point (canonical and non-canonical y, both sign bits).

    Derived, not hardcoded: enumerate the 8-torsion subgroup, then probe
    each candidate encoding through point_decompress itself.  Used by
    verify to reject small-order A/R with a byte compare instead of
    [8]P == identity point math (reference behavior contract:
    fd_ed25519_user.c:154-198 small-order rejection).
    """
    # find an order-8 generator: L * (any point) lies in the torsion group
    torsion = set()
    y = 2
    while True:
        cand = point_decompress(int(y).to_bytes(32, "little"))
        if cand is not None:
            t = scalar_mul(L, cand)
            q, order = t, 1
            while q != IDENT:
                q = point_add(q, t)
                order += 1
            if order == 8:
                torsion = {scalar_mul(i, t) for i in range(8)}
                break
        y += 1
    out = []
    for x, ty in sorted(torsion):
        for y_enc in (ty, ty + P):
            if y_enc >= 1 << 255:
                continue
            for sign in (0, 1):
                enc = int.to_bytes(y_enc | (sign << 255), 32, "little")
                got = point_decompress(enc)
                if got is not None and is_small_order(got):
                    out.append(enc)
    return sorted(set(out))


# ---------------------------------------------------------------------------
# Sign / verify
# ---------------------------------------------------------------------------

def _sha512_int(*chunks: bytes) -> int:
    h = hashlib.sha512()
    for c in chunks:
        h.update(c)
    return int.from_bytes(h.digest(), "little")


def secret_expand(secret: bytes):
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_from_secret(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(scalar_mul(a, B))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(secret)
    A = point_compress(scalar_mul(a, B))
    r = _sha512_int(prefix, msg) % L
    Rs = point_compress(scalar_mul(r, B))
    k = _sha512_int(Rs, A, msg) % L
    s = (r + k * a) % L
    return Rs + int.to_bytes(s, 32, "little")


def verify(msg: bytes, sig: bytes, pubkey: bytes) -> int:
    """Returns ERR_OK (0) on success, negative error code otherwise."""
    if len(sig) != 64 or len(pubkey) != 32:
        return ERR_SIG
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return ERR_SIG
    A = point_decompress(pubkey)
    if A is None:
        return ERR_PUBKEY
    R = point_decompress(sig[:32])
    if R is None:
        return ERR_SIG
    if is_small_order(A):
        return ERR_PUBKEY
    if is_small_order(R):
        return ERR_SIG
    k = _sha512_int(sig[:32], pubkey, msg) % L
    # Rcmp = [k](-A) + [s]B, compared against decompressed R
    rcmp = point_add(scalar_mul(k, point_neg(A)), scalar_mul(s, B))
    return ERR_OK if rcmp == R else ERR_MSG
