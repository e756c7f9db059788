"""Arithmetic mod the Ed25519 group order L, batch-last int32 limbs.

The plain PyTorch counterpart of firedancer_tpu/ops/ed25519/scalar.py
(`from_bytes`, `is_canonical`, `reduce512`, `to_signed_digits`, and the
batch-verification prologue's `mulmod` and `summod`), in the same
radix-2^13 / 20-limb layout.  L = 2^252 + c
with c ~ 2^125; the 512-bit reduction folds high limbs through a table of
2^(13*i) mod L.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F
from .golden import L

RADIX = F.RADIX
NLIMB = F.NLIMB
MASK = F.MASK

_C = L - (1 << 252)  # the "c" in L = 2^252 + c
_L_LIMBS = F.int_to_limbs(L).reshape(NLIMB, 1)
_C_LIMBS = F.int_to_limbs(_C).reshape(NLIMB, 1)
# _R_POW[i] = 2^(13*(NLIMB+i)) mod L for i in 0..20, canonical limbs (21, 20)
_R_POW = np.stack(
    [F.int_to_limbs(pow(2, RADIX * (NLIMB + i), L)) for i in range(NLIMB + 1)]
)
# sum_i 8 * 16^i for i in 0..63: adding it makes every nibble of the sum
# equal (nibble + 8 + incoming carry), so signed digits fall out of one add,
# one ripple and a nibble extract
_EIGHTS = F.int_to_limbs(sum(8 << (4 * i) for i in range(64))).reshape(
    NLIMB, 1
)
F.register_const("L", _L_LIMBS)
F.register_const("C", _C_LIMBS)
F.register_const("R_POW", _R_POW)
F.register_const("EIGHTS", _EIGHTS)

_ripple = F.ripple


def from_bytes(b):
    """(B, 32) uint8 little-endian -> (NLIMB, B) limbs (value < 2^256)."""
    return F.from_bytes(b)


def is_canonical(s):
    """(NLIMB, B) canonical-shaped limbs -> (B,) bool: s < L."""
    _, borrow = _ripple(s - F.c("L", s.device))
    return borrow[0] < 0


def _fold_once(lo, hi):
    """value = lo + sum_i hi[i] * 2^(13*(NLIMB+i)) -> smaller equivalent.

    Each output column takes <= 21 products of 13-bit values plus the lo
    limb: < 21 * 2^26 + 2^13 < 2^31, exact in int32."""
    r = F.c("R_POW", lo.device)[: hi.shape[0]]  # (nh, NLIMB)
    contrib = (hi[:, None, :] * r[:, :, None]).sum(0, dtype=torch.int32)
    return lo + contrib


def _reduce_wide(x):
    """(n, B) 13-bit limbs, NLIMB < n <= 2*NLIMB+1 -> canonical scalar."""
    v = _fold_once(x[:NLIMB], x[NLIMB:])
    for _ in range(5):
        v, co = _ripple(v)
        v = _fold_once(v, co)
    v, _ = _ripple(v)  # carry out is 0 now (value < 2^260)

    # split at bit 252 (bit 5 of limb 19):
    # value = hi * 2^252 + lo252  ===  lo252 - hi * c  (mod L)
    hi = v[NLIMB - 1 :] >> 5
    lo = torch.cat([v[: NLIMB - 1], v[NLIMB - 1 :] & 31], dim=0)
    w, carry = _ripple(lo - hi * F.c("C", x.device))
    # carry in {-1, 0}: negative means w < 0 -> add L once
    w_fixed, _ = _ripple(w + F.c("L", x.device))
    return torch.where(carry < 0, w_fixed, w)


def reduce512(digest):
    """(B, 64) uint8 little-endian 512-bit -> canonical scalar (NLIMB, B).

    This is the `k = SHA512(R||A||M) mod L` step of verify."""
    # 40 limbs cover 520 >= 512 bits
    return _reduce_wide(F.bytes_to_limbs(digest, 2 * NLIMB))


def mulmod(a, b):
    """(na, B) x (nb, B) 13-bit limb scalars -> a*b mod L, canonical.

    Exactness: schoolbook columns accumulate min(na, nb) products of
    13-bit limbs, so min(na, nb) <= 20 keeps every column < 20 * 2^26
    < 2^31 (int32 exact); na + nb <= 40 keeps the rippled product inside
    _reduce_wide's 41-limb fold table.  Used by the batch-verification
    prologue for z*k and z*s (z is a 128-bit = 10-limb random scalar)."""
    na, nb = a.shape[0], b.shape[0]
    a, b = torch.broadcast_tensors(a[:, None], b[None, :])
    cols = torch.zeros((na + nb - 1,) + a.shape[2:], dtype=torch.int32,
                       device=a.device)
    for i in range(na):
        cols[i : i + nb] += a[i] * b[i]
    v, co = _ripple(cols)  # co < 2^13 (product < 2^(13*(na+nb)))
    return _reduce_wide(torch.cat([v, co], dim=0))


def summod(x):
    """(NLIMB, B) 13-bit limb scalars -> sum mod L as (NLIMB, 1).

    Pairwise tree: each level adds halves and ripples; carries past limb
    19 (values >= 2^260) fold back through _R_POW so limbs stay 13-bit
    and the running value stays < 2^254 at every level."""
    n = x.shape[-1]
    p2 = 1 << max(0, (n - 1).bit_length())
    if p2 != n:
        x = torch.cat([x, torch.zeros_like(x[:, :1]).expand(-1, p2 - n)], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        v, co = _ripple(x[:, :half] + x[:, half:])
        x = _fold_once(v, co)
        x, co = _ripple(x)  # _fold_once leaves limbs up to ~2^26: renorm
        x = _fold_once(x, co)  # the carry past limb 19, folded back mod L
    return _reduce_wide(x)


def to_nibbles(s):
    """Canonical-shaped (NLIMB, B) limbs -> (64, B) radix-16 digits, LSB
    first (covers 256 bits)."""
    padded = torch.cat([s, torch.zeros_like(s[:1])], dim=0)
    out = []
    for j in range(64):
        o = 4 * j
        l0, sh = o // RADIX, o % RADIX
        window = padded[l0] + (padded[l0 + 1] << RADIX)
        out.append((window >> sh) & 15)
    return torch.stack(out, dim=0)


def to_signed_digits(s):
    """Canonical-shaped (NLIMB, B) limbs -> (64, B) digits in [-8, 7] with
    s == sum_i d_i 16^i.  Exact for s < 2^253 (any canonical scalar); lanes
    with larger non-canonical s get garbage digits, but is_canonical has
    already rejected them."""
    t, _ = _ripple(s + F.c("EIGHTS", s.device))
    return to_nibbles(t) - 8
