"""GF(2^255-19) arithmetic on int32 limb tensors, batch-last layout.

The plain PyTorch counterpart of firedancer_tpu/ops/ed25519/field.py, in the
same representation so that every intermediate can be held against the JAX
package bit for bit: radix 2^13, 20 limbs per element, int32, an element is
a (20, B) tensor with the batch axis last.  The representation is redundant
("loose"): carried values (mul/carry outputs) have limbs in [-1218, 8801];
add/sub are lazy, and `mul` accepts any lazy chain with |limb| <= 2^17
(LOOSE_MAX).  2^260 === 608 (mod p) folds columns >= 20 back down.

What differs from the JAX module is idiom only:

  * The schoolbook convolution is one broadcast product and one
    `index_add_` into its columns, not a Karatsuba tree of static slices:
    the columns are the same integers (the Karatsuba bounds of
    tests/test_field_bounds.py bound these columns too), so every carried
    output limb is identical.
  * There is no `const_scope`: that routing exists only because a Pallas
    kernel cannot capture constants.  Constants are module tensors, moved
    to the operand's device on first use.

This module is the plain version that the port's CUDA kernel
(csrc/verify_core.cu) is held against; the kernel keeps its own limb
representation and agrees at the interface (bytes, canonical values, bools).
"""

from __future__ import annotations

import numpy as np
import torch

from . import golden

RADIX = 13
NLIMB = 20  # 260 bits
MASK = (1 << RADIX) - 1
FOLD = 608  # 2^260 mod p  (= 19 * 2^5)
LOOSE_MAX = 1 << 17  # |limb| bound required at mul/carry input

P = golden.P
D = golden.D
SQRT_M1 = golden.SQRT_M1


# ---------------------------------------------------------------------------
# Host-side conversions (python int <-> limbs) for constants and tests
# ---------------------------------------------------------------------------


def int_to_limbs(x: int) -> np.ndarray:
    """Python int (0 <= x < 2^260) -> (NLIMB,) int32 canonical limbs."""
    assert 0 <= x < 1 << (RADIX * NLIMB)
    return np.array(
        [(x >> (RADIX * i)) & MASK for i in range(NLIMB)], dtype=np.int32
    )


def limbs_to_int(l):
    """(NLIMB, ...) limbs -> python int, or a list of them for a batch
    (exact, handles loose/negative limbs)."""
    l = l.cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l)
    assert l.shape[0] == NLIMB
    flat = l.reshape(NLIMB, -1)
    out = [
        sum(int(flat[i, j]) << (RADIX * i) for i in range(NLIMB))
        for j in range(flat.shape[1])
    ]
    return out[0] if len(out) == 1 else out


def const(x: int) -> np.ndarray:
    """Constant field element as (NLIMB, 1) limbs (broadcasts over batch)."""
    return int_to_limbs(x % P).reshape(NLIMB, 1)


_CONSTS = {
    "ONE": const(1),
    "D": const(D),
    "D2": const(2 * D),
    "SQRT_M1": const(SQRT_M1),
    # 32*p = 2^260 - 608: added before canonicalization so loose negative
    # limbs cannot drive the value negative
    "P32": int_to_limbs(32 * P).reshape(NLIMB, 1),
    "P": int_to_limbs(P).reshape(NLIMB, 1),
}
_ON_DEVICE: dict = {}


def register_const(name: str, value: np.ndarray) -> None:
    _CONSTS[name] = np.ascontiguousarray(value, dtype=np.int32)


def c(name: str, device) -> torch.Tensor:
    """Constant `name` as an int32 tensor on `device` (cached per device)."""
    key = (name, torch.device(device))
    t = _ON_DEVICE.get(key)
    if t is None:
        t = torch.from_numpy(_CONSTS[name]).to(device)
        _ON_DEVICE[key] = t
    return t


# ---------------------------------------------------------------------------
# Carry plumbing
# ---------------------------------------------------------------------------


def _add_at0(x, v):
    """x with v (shape (1, B)) added to limb 0."""
    return torch.cat([x[0:1] + v, x[1:]], dim=0)


def _pass(x):
    """One parallel carry pass: x -> (same value with limbs closer to
    13-bit, signed carry out of the top limb (1, B)).  Arithmetic >> gives
    floor semantics, so negative limbs carry correctly."""
    lo = x & MASK
    hi = x >> RADIX
    shifted = torch.cat([torch.zeros_like(hi[:1]), hi[:-1]], dim=0)
    return lo + shifted, hi[-1:]


def _carry20(x):
    """Normalize a (NLIMB, B) loose value: two passes, 2^260-fold carries."""
    x, co = _pass(x)
    x = _add_at0(x, co * FOLD)
    x, co = _pass(x)
    return _add_at0(x, co * FOLD)


def carry1(x):
    """One-pass cheap carry for |limb| <= 2^17: output |limb| <= 8209."""
    x, co = _pass(x)
    x = _add_at0(x, co * FOLD)
    l0 = x[0:1]
    return torch.cat([l0 & MASK, x[1:2] + (l0 >> RADIX), x[2:]], dim=0)


def ripple(x):
    """Exact sequential carry over the limbs: -> (limbs in [0, 2^13),
    signed carry out (1, B)).  Shared with the scalar (mod L) code."""
    out = []
    carry = torch.zeros_like(x[0:1])
    for i in range(x.shape[0]):
        v = x[i : i + 1] + carry
        out.append(v & MASK)
        carry = v >> RADIX
    return torch.cat(out, dim=0), carry


_CONV_IDX: dict = {}


def _conv_index(device) -> torch.Tensor:
    """(NLIMB*NLIMB,) column index i+j of each product a_i * b_j."""
    key = torch.device(device)
    t = _CONV_IDX.get(key)
    if t is None:
        i = torch.arange(NLIMB)
        t = (i[:, None] + i[None, :]).reshape(-1).to(device)
        _CONV_IDX[key] = t
    return t


def _conv(a, b):
    """(NLIMB, B) x (NLIMB, B) -> (2*NLIMB+1, B) schoolbook columns."""
    a, b = torch.broadcast_tensors(a, b)
    prod = (a[:, None, :] * b[None, :, :]).reshape(NLIMB * NLIMB, -1)
    cols = torch.zeros(
        (2 * NLIMB + 1, prod.shape[1]), dtype=torch.int32, device=a.device
    )
    return cols.index_add_(0, _conv_index(a.device), prod)


def _reduce_conv(cols):
    """(2*NLIMB+1, B) convolution columns -> (NLIMB, B) carried limbs."""
    # two parallel passes; the zero pad limbs at the top absorb the carries
    cols, _ = _pass(cols)
    cols, _ = _pass(cols)
    lo, hi = cols[:NLIMB], cols[NLIMB:]
    lo = lo + FOLD * hi[:NLIMB]
    lo = _add_at0(lo, (FOLD * FOLD) * hi[NLIMB : NLIMB + 1])
    return _carry20(lo)


# ---------------------------------------------------------------------------
# Loose arithmetic
# ---------------------------------------------------------------------------


def carry(a):
    """Re-normalize a loose element to |limb| <= ~2^13."""
    return _carry20(a)


def mul_rr(a, b):
    """Raw field multiply, NO input normalization: the caller keeps the
    operands inside the carried contract (see field.py of the JAX package
    and tests/test_field_bounds.py)."""
    return _reduce_conv(_conv(a, b))


def sqr_rr(a):
    """Raw squaring (same columns as mul_rr(a, a))."""
    return _reduce_conv(_conv(a, a))


def mul(a, b):
    """Field multiply.  Inputs may be lazy add/sub chains, |limb| <= 2^17."""
    return mul_rr(_carry20(a), _carry20(b))


def _sqr_n(a, n: int):
    """n raw squarings (input must be carried; outputs are carried)."""
    for _ in range(n):
        a = sqr_rr(a)
    return a


def pow_p58(z):
    """z^((p-5)/8) = z^(2^252 - 3): the ref10 exponentiation chain.

    Input must be carried (a mul/sqr output)."""
    z2 = sqr_rr(z)  # 2
    z9 = mul_rr(_sqr_n(z2, 2), z)  # 9
    z11 = mul_rr(z9, z2)  # 11
    z_5_0 = mul_rr(sqr_rr(z11), z9)  # 2^5 - 1
    z_10_0 = mul_rr(_sqr_n(z_5_0, 5), z_5_0)  # 2^10 - 1
    z_20_0 = mul_rr(_sqr_n(z_10_0, 10), z_10_0)  # 2^20 - 1
    z_40_0 = mul_rr(_sqr_n(z_20_0, 20), z_20_0)  # 2^40 - 1
    z_50_0 = mul_rr(_sqr_n(z_40_0, 10), z_10_0)  # 2^50 - 1
    z_100_0 = mul_rr(_sqr_n(z_50_0, 50), z_50_0)  # 2^100 - 1
    z_200_0 = mul_rr(_sqr_n(z_100_0, 100), z_100_0)  # 2^200 - 1
    z_250_0 = mul_rr(_sqr_n(z_200_0, 50), z_50_0)  # 2^250 - 1
    return mul_rr(_sqr_n(z_250_0, 2), z)  # 2^252 - 3


def invert(z):
    """z^(p-2): pow_p58 extended by 3 squarings.  Input must be carried."""
    # p - 2 = 8 * (2^252 - 3) + 3  ->  (z^(2^252-3))^8 * z^3
    t = _sqr_n(pow_p58(z), 3)
    return mul_rr(t, mul_rr(sqr_rr(z), z))


# ---------------------------------------------------------------------------
# Canonicalization, comparison, bytes
# ---------------------------------------------------------------------------


def canonical(a):
    """Loose -> unique canonical limbs in [0, p), fully carried."""
    # normalize so |value| < 2^248-ish, then make non-negative with 32p
    x = _carry20(a) + c("P32", a.device)
    x, carry_out = ripple(x)
    # carry_out in [0, 2]: fold 2^260 -> 608 and ripple again
    x, _ = ripple(_add_at0(x, carry_out * FOLD))
    # 0 <= x < 2^260: fold bits >= 255 (limb 19 holds bits 247..259)
    for _ in range(2):
        hi = x[NLIMB - 1 :] >> 8
        x = torch.cat([x[: NLIMB - 1], x[NLIMB - 1 :] & 0xFF], dim=0)
        x, _ = ripple(_add_at0(x, hi * 19))
    # 0 <= x < 2^255: subtract p once if x >= p
    d, borrow = ripple(x - c("P", a.device))
    return torch.where(borrow >= 0, d, x)


def eq(a, b):
    """Exact field equality of two loose elements -> (B,) bool."""
    return torch.all(canonical(a) == canonical(b), dim=0)


def is_zero(a):
    return torch.all(canonical(a) == 0, dim=0)


def parity(a):
    """Canonical low bit ("sign" bit of x in RFC 8032) -> (B,) int32 0/1."""
    return canonical(a)[0] & 1


_FB_BYTE0 = np.array([(RADIX * k) >> 3 for k in range(2 * NLIMB)])
_FB_SHIFT = np.array([(RADIX * k) & 7 for k in range(2 * NLIMB)])


def bytes_to_limbs(b, nlimb: int):
    """(B, n) uint8 little-endian -> (nlimb, B) 13-bit limbs (shared with
    the scalar code, which reads 40 limbs of a 64-byte digest)."""
    b = b.to(torch.int32)
    padded = torch.cat([b, torch.zeros_like(b[:, :2])], dim=1)
    byte0 = torch.from_numpy(_FB_BYTE0[:nlimb]).to(b.device)
    shift = torch.from_numpy(_FB_SHIFT[:nlimb]).to(torch.int32).to(b.device)
    window = (
        padded[:, byte0]
        | (padded[:, byte0 + 1] << 8)
        | (padded[:, byte0 + 2] << 16)
    )
    return ((window >> shift) & MASK).T.contiguous()


def from_bytes(b):
    """(B, 32) uint8 little-endian -> (NLIMB, B) limbs of the 256-bit value.

    Bit 255 (the compression sign bit) is INCLUDED if set; callers mask it.
    Non-canonical encodings (>= p) are kept as they are."""
    return bytes_to_limbs(b, NLIMB)


def to_bytes(a):
    """Loose element -> canonical (B, 32) uint8 little-endian."""
    x = canonical(a)
    padded = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    out = []
    for j in range(32):
        o = 8 * j
        l0, sh = o // RADIX, o % RADIX
        window = padded[l0] + (padded[l0 + 1] << RADIX)
        out.append(((window >> sh) & 0xFF).to(torch.uint8))
    return torch.stack(out, dim=-1)
