"""Host-side Ed25519: a fast signer for corpora and the strict host verify.

A copy of firedancer_tpu/ops/ed25519/hostpath.py (`public_from_secret`,
`sign`, `_shamir`, `verify_digest`, `verify_batch_digest_host`), kept in the
port so that firedancer_tpu_torch imports nothing of the JAX package.  Group
math runs in extended homogeneous coordinates (add-2008-hwcd / dbl-2008-hwcd
for a = -1) with no per-add field inversion, so one signature or one lane's
verify costs a few milliseconds of plain-int arithmetic instead of golden's
quarter second; the outputs are identical to golden's.

verify_batch_digest_host has the device path's behavior contract
(ops/ed25519/verify.py steps 1-3 and 5, digest form): canonical s, the
small-order blocklist on the encodings of A and R, decompression,
cofactorless [k](-A) + [s]B == R.  It is the verify pool's last resort
(tiles/verify.py) when every device domain is out: a policy of the pool, not
a fallback of the device entry points, which raise on the card.
"""

from __future__ import annotations

import functools as _functools

import numpy as np

from . import golden

P = golden.P
D = golden.D
L = golden.L

#: identity in extended homogeneous coordinates (X : Y : Z : T), T = XY/Z
_IDENT = (0, 1, 1, 0)

_BLOCKLIST = frozenset(golden.small_order_blocklist())

_2D = (2 * D) % P


def _ext(p) -> tuple:
    """Affine (x, y) -> extended (X : Y : Z=1 : T)."""
    x, y = p
    return (x, y, 1, x * y % P)


def _ext_add(p, q):
    """add-2008-hwcd-3 for a = -1 (no inversions)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * _2D % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _ext_dbl(p):
    """dbl-2008-hwcd for a = -1."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = (b - a) % P
    f = (g - c) % P
    h = (-a - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _shamir(k: int, pk, s: int, ps):
    """k*pk + s*ps via one interleaved MSB-first ladder."""
    both = _ext_add(pk, ps)
    acc = _IDENT
    for i in range(max(k.bit_length(), s.bit_length()) - 1, -1, -1):
        acc = _ext_dbl(acc)
        bk, bs = (k >> i) & 1, (s >> i) & 1
        if bk and bs:
            acc = _ext_add(acc, both)
        elif bk:
            acc = _ext_add(acc, pk)
        elif bs:
            acc = _ext_add(acc, ps)
    return acc


_B_EXT = _ext(golden.B)


def _scalar_mul(k: int, p):
    """k*p, extended coords, MSB-first double-and-add."""
    acc = _IDENT
    for i in range(k.bit_length() - 1, -1, -1):
        acc = _ext_dbl(acc)
        if (k >> i) & 1:
            acc = _ext_add(acc, p)
    return acc


def _compress(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return golden.point_compress((x * zi % P, y * zi % P))


@_functools.lru_cache(maxsize=256)
def _expand(secret: bytes) -> tuple:
    """(a, prefix, A): the per-secret constants -- one base-point ladder
    per signer, not per signature."""
    a, prefix = golden.secret_expand(secret)
    return a, prefix, _compress(_scalar_mul(a, _B_EXT))


def public_from_secret(secret: bytes) -> bytes:
    """golden.public_from_secret, ~50x faster (same output bytes)."""
    return _expand(secret)[2]


def sign(secret: bytes, msg: bytes) -> bytes:
    """golden.sign, ~50x faster (bit-identical signatures)."""
    a, prefix, A = _expand(secret)
    r = golden._sha512_int(prefix, msg) % L
    Rs = _compress(_scalar_mul(r, _B_EXT))
    k = golden._sha512_int(Rs, A, msg) % L
    s = (r + k * a) % L
    return Rs + int.to_bytes(s, 32, "little")


def verify_digest(digest: bytes, sig: bytes, pub: bytes) -> bool:
    """One lane: digest = SHA512(R || A || M), the k pre-hash."""
    if len(sig) != 64 or len(pub) != 32 or len(digest) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    if pub in _BLOCKLIST or sig[:32] in _BLOCKLIST:
        return False
    a_pt = golden.point_decompress(pub)
    if a_pt is None:
        return False
    r_pt = golden.point_decompress(sig[:32])
    if r_pt is None:
        return False
    k = int.from_bytes(digest, "little") % L
    x, y, z, _ = _shamir(k, _ext(golden.point_neg(a_pt)), s, _B_EXT)
    rx, ry = r_pt
    # projective equality against affine R: X == Rx*Z, Y == Ry*Z
    return x == rx * z % P and y == ry * z % P


def verify_batch_digest_host(
    digests: np.ndarray,
    sigs: np.ndarray,
    pubs: np.ndarray,
    lanes: int | None = None,
) -> np.ndarray:
    """Batch form matching verify.verify_batch_digest's shape contract:
    (B, 64) digests, (B, 64) sigs, (B, 32) pubs -> (B,) bool numpy.
    `lanes` skips zero-padding rows (their result is never consumed)."""
    n = len(sigs)
    live = n if lanes is None else min(int(lanes), n)
    out = np.zeros(n, dtype=bool)
    dg = np.asarray(digests, np.uint8)
    sg = np.asarray(sigs, np.uint8)
    pb = np.asarray(pubs, np.uint8)
    for i in range(live):
        out[i] = verify_digest(
            dg[i].tobytes(), sg[i].tobytes(), pb[i].tobytes()
        )
    return out
