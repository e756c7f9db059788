"""Ed25519 group ops on extended twisted-Edwards coordinates, batched.

The plain PyTorch counterpart of firedancer_tpu/ops/ed25519/point.py: a point
is a 4-tuple (X, Y, Z, T) of field.py limb tensors (batch axis last) with
x = X/Z, y = Y/Z, T = XY/Z, under the complete a = -1 formulas
(add-2008-hwcd-3 / dbl-2008-hwcd).  Scalar multiplication is the Strauss
interleaved double-scalar-mul with signed 4-bit windows (digits in [-8, 7])
against 9-entry niels tables; F.carry1 normalizations sit exactly where the
JAX module's machine-checked carry contract puts them.

This is the plain path that csrc/verify_core.cu is held against.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as F
from . import golden

# ---------------------------------------------------------------------------
# Core formulas
# ---------------------------------------------------------------------------


def identity(batch: int, device):
    z = torch.zeros((F.NLIMB, batch), dtype=torch.int32, device=device)
    one = F.c("ONE", device).expand(F.NLIMB, batch).contiguous()
    return (z, one, one, z)


def negate(p):
    x, y, z, t = p
    return (-x, y, z, -t)


def double(p, with_t: bool = True):
    """Unified extended doubling (dbl-2008-hwcd, a=-1).  Input coords must
    be carried.  Without T the T output is zeros (one mul saved)."""
    x, y, z, _ = p
    a = F.sqr_rr(x)
    b = F.sqr_rr(y)
    c2 = F.sqr_rr(z)
    e = F.carry1(F.sqr_rr(F.carry1(x + y)) - a - b)
    g = b - a
    f = F.carry1(g - c2 - c2)
    h = F.carry1(-(a + b))
    t3 = F.mul_rr(e, h) if with_t else torch.zeros_like(a)
    return (F.mul_rr(e, f), F.mul_rr(g, h), F.mul_rr(f, g), t3)


def add(p, q):
    """Unified extended addition (add-2008-hwcd-3, a=-1, k=2d) of two full
    extended points (table building)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = F.mul_rr(y1 - x1, F.carry1(y2 - x2))
    b = F.mul_rr(F.carry1(y1 + x1), F.carry1(y2 + x2))
    c = F.mul_rr(F.mul_rr(t1, F.c("D2", t1.device)), t2)
    zz = F.mul_rr(z1, z2)
    e = F.carry1(b - a)
    f = F.carry1(zz + zz - c)
    g = F.carry1(zz + zz + c)
    h = F.carry1(b + a)
    return (F.mul_rr(e, f), F.mul_rr(g, h), F.mul_rr(f, g), F.mul_rr(e, h))


# ---------------------------------------------------------------------------
# Niels-form table entries
# ---------------------------------------------------------------------------


def to_niels(p):
    """Extended point -> (Y+X, Y-X, 2dT, 2Z), all carried."""
    x, y, z, t = p
    return (
        F.carry(y + x),
        F.carry(y - x),
        F.mul_rr(t, F.c("D2", t.device)),
        F.carry(z + z),
    )


def to_niels_affine(p):
    """Extended point with Z == 1 (a decompress output) ->
    (y+x, y-x, 2dxy) affine niels, all carried."""
    x, y, _, t = p
    return (F.carry(y + x), F.carry(y - x), F.mul_rr(t, F.c("D2", t.device)))


def identity_niels_affine(batch: int, device):
    one = F.c("ONE", device).expand(F.NLIMB, batch).contiguous()
    return (one, one, torch.zeros_like(one))


def identity_niels(batch: int, device):
    one = F.c("ONE", device).expand(F.NLIMB, batch).contiguous()
    return (one, one, torch.zeros_like(one), one + one)


def add_niels(p, e, with_t: bool = True):
    """p + e where e = (Y+X, Y-X, 2dT, 2Z) niels form (projective)."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d, z2e = e
    a = F.mul_rr(y1 - x1, ymx)
    b = F.mul_rr(F.carry1(y1 + x1), ypx)
    c = F.mul_rr(t1, t2d)
    d2 = F.mul_rr(z1, z2e)
    ec = F.carry1(b - a)
    f = d2 - c
    g = F.carry1(d2 + c)
    h = F.carry1(b + a)
    t3 = F.mul_rr(ec, h) if with_t else torch.zeros_like(a)
    return (F.mul_rr(ec, f), F.mul_rr(g, h), F.mul_rr(f, g), t3)


def add_niels_affine(p, e, with_t: bool = False):
    """p + e where e = (y+x, y-x, 2dxy) affine niels (Z == 1 implicit)."""
    x1, y1, z1, t1 = p
    ypx, ymx, t2d = e
    a = F.mul_rr(y1 - x1, ymx)
    b = F.mul_rr(F.carry1(y1 + x1), ypx)
    c = F.mul_rr(t1, t2d)
    ec = F.carry1(b - a)
    f = F.carry1(z1 + z1 - c)
    g = F.carry1(z1 + z1 + c)
    h = F.carry1(b + a)
    t3 = F.mul_rr(ec, h) if with_t else torch.zeros_like(a)
    return (F.mul_rr(ec, f), F.mul_rr(g, h), F.mul_rr(f, g), t3)


# ---------------------------------------------------------------------------
# Decompress / predicates
# ---------------------------------------------------------------------------


def decompress_bytes(b):
    """(B, 32) uint8 -> (y limbs (NLIMB, B), sign (1, B) int32): the byte
    parsing half of decompress, run before the verify kernel."""
    sign = (b[:, 31:32] >> 7).to(torch.int32).T.contiguous()
    masked = b.clone()
    masked[:, 31] &= 0x7F
    return F.from_bytes(masked), sign


def decompress_limbs(y, sign):
    """(y limbs, sign (1, B)) -> (point, ok (B,)).

    Verify rules: non-canonical y (>= p) accepted, sqrt failure rejected,
    x == 0 with the sign bit set ("negative zero") rejected.  Lanes with
    ok == False carry garbage coordinates; callers mask them out."""
    one = F.c("ONE", y.device)
    ysq = F.sqr_rr(y)
    u = ysq - one
    v = F.carry1(F.mul_rr(F.c("D", y.device), ysq) + one)
    # candidate root x = u v^3 (u v^7)^((p-5)/8)   (ref10)
    v3 = F.mul_rr(F.sqr_rr(v), v)
    v7 = F.mul_rr(F.sqr_rr(v3), v)
    t = F.pow_p58(F.mul_rr(F.carry1(u), v7))
    x = F.mul_rr(F.mul_rr(F.carry1(u), v3), t)
    vxx = F.mul_rr(v, F.sqr_rr(x))
    ok_direct = F.eq(vxx, u)
    ok_flip = F.eq(vxx, -u)
    x = torch.where(ok_flip[None], F.mul_rr(x, F.c("SQRT_M1", y.device)), x)
    ok = ok_direct | ok_flip
    x_is_zero = F.is_zero(x)
    ok = ok & ~(x_is_zero & (sign[0] == 1))
    # choose the root with matching parity
    flip = (F.parity(x)[None] != sign) & ~x_is_zero[None]
    x = F.carry1(torch.where(flip, -x, x))
    z = one.expand_as(x).contiguous()
    return (x, y, z, F.mul_rr(x, F.carry1(y))), ok


def decompress(b):
    """(B, 32) uint8 -> (point, ok).  See decompress_limbs for rules."""
    y, sign = decompress_bytes(b)
    return decompress_limbs(y, sign)


def compress(p):
    """Point -> (B, 32) uint8 canonical encoding (via one inversion)."""
    x, y, z, _ = p
    zinv = F.invert(F.carry1(z))
    xa = F.canonical(F.mul_rr(F.carry1(x), zinv))
    yb = F.to_bytes(F.mul_rr(F.carry1(y), zinv))
    yb[:, 31] |= ((xa[0] & 1) << 7).to(torch.uint8)
    return yb


def eq_points(p, q):
    """General projective equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    z1c = F.carry1(z1)
    z2c = F.carry1(z2)
    return F.eq(F.mul_rr(F.carry1(x1), z2c), F.mul_rr(F.carry1(x2), z1c)) & (
        F.eq(F.mul_rr(F.carry1(y1), z2c), F.mul_rr(F.carry1(y2), z1c))
    )


def eq_external(acc, r):
    """Projective acc == affine-decompressed r (Z_r == 1), no inversion."""
    xa, ya, za, _ = acc
    xr, yr, _, _ = r
    zc = F.carry1(za)
    return F.eq(F.mul_rr(F.carry1(xr), zc), xa) & F.eq(
        F.mul_rr(F.carry1(yr), zc), ya
    )


# ---------------------------------------------------------------------------
# Tables + double scalar mul
# ---------------------------------------------------------------------------


def base_table9_ints() -> list:
    """[(y+x, y-x, 2dxy) mod p for i*B, i in 0..8] as python ints, from the
    golden oracle.  Shared by B_TABLE9 and the CUDA kernel's table."""
    rows = []
    acc = golden.IDENT
    for _ in range(9):
        x, y = acc
        rows.append(
            ((y + x) % golden.P, (y - x) % golden.P,
             2 * golden.D * x % golden.P * y % golden.P)
        )
        acc = golden.point_add(acc, golden.B)
    return rows


#: (9, 3, NLIMB, 1): affine niels of i*B, canonical limbs
B_TABLE9 = np.stack(
    [
        np.stack([F.int_to_limbs(v).reshape(F.NLIMB, 1) for v in row])
        for row in base_table9_ints()
    ]
)
F.register_const("B_TABLE9", B_TABLE9)


def build_neg_table9(a_pt):
    """Table (9, 4, NLIMB, B): niels form of i*(-A) for i in 0..8."""
    na = negate(a_pt)
    pts = [na]  # 1
    pts.append(double(pts[0]))  # 2
    pts.append(add(pts[1], na))  # 3
    pts.append(double(pts[1]))  # 4
    pts.append(add(pts[3], na))  # 5
    pts.append(double(pts[2]))  # 6
    pts.append(add(pts[5], na))  # 7
    pts.append(double(pts[3]))  # 8
    batch = a_pt[0].shape[-1]
    entries = [identity_niels(batch, a_pt[0].device)]
    entries += [to_niels(p) for p in pts]
    return torch.stack([torch.stack(e) for e in entries])


def _select(table, digit):
    """table (9, C, NLIMB, B), digit (B,) -> (C, NLIMB, B) entry |digit|."""
    idx = digit.abs().long()[None, None, None, :]
    idx = idx.expand(1, table.shape[1], table.shape[2], digit.shape[0])
    return torch.gather(table, 0, idx)[0]


def lookup9(table, digit):
    """table (9, 4, NLIMB, B), digit (B,) in [-8, 8] -> niels entry tuple;
    negation (swap Y+X <-> Y-X, negate 2dT) where digit < 0."""
    ypx, ymx, t2d, z2e = _select(table, digit)
    neg = (digit < 0)[None, :]
    return (
        torch.where(neg, ymx, ypx),
        torch.where(neg, ypx, ymx),
        torch.where(neg, -t2d, t2d),
        z2e,
    )


def lookup9_affine(table, digit):
    """table (9, 3, NLIMB, B or 1), digit (B,) -> affine niels tuple."""
    table = table.expand(table.shape[:-1] + (digit.shape[0],))
    ypx, ymx, t2d = _select(table, digit)
    neg = (digit < 0)[None, :]
    return (
        torch.where(neg, ymx, ypx),
        torch.where(neg, ypx, ymx),
        torch.where(neg, -t2d, t2d),
    )


def scalar_mul_base(s_digits):
    """[s]B from (64, B) signed digits: fixed-base Strauss over the shared
    affine B table.  The [u]B term of batch (RLC) verification, where B is
    1; a Python loop of 64 steps."""
    batch = s_digits.shape[-1]
    b_table = F.c("B_TABLE9", s_digits.device)
    acc = identity(batch, s_digits.device)
    for idx in range(63, -1, -1):
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=True)
        acc = add_niels_affine(
            acc, lookup9_affine(b_table, s_digits[idx]), with_t=True
        )
    return acc


def double_scalar_mul(k_digits, neg_a_table9, s_digits):
    """[k](-A) + [s]B with signed 4-bit interleaved windows.

    k_digits, s_digits: (64, B) int32 digits in [-8, 7], LSB first; the
    loop walks them from row 63 down to row 0."""
    batch = k_digits.shape[-1]
    b_table = F.c("B_TABLE9", k_digits.device)
    acc = identity(batch, k_digits.device)
    for idx in range(63, -1, -1):
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=False)
        acc = double(acc, with_t=True)
        acc = add_niels(acc, lookup9(neg_a_table9, k_digits[idx]), with_t=True)
        acc = add_niels_affine(
            acc, lookup9_affine(b_table, s_digits[idx]), with_t=False
        )
    return acc
