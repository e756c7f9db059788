"""Batched Ed25519 verification on the card.

The PyTorch counterpart of the per-signature path of
firedancer_tpu/ops/ed25519/verify.py.  Behavior contract (RFC 8032 plus the
golden oracle; reference parity target fd_ed25519_verify):

  1. reject non-canonical s (s >= L)
  2. decompress A (pubkey) and R (sig[0:32]); non-canonical y accepted,
     "negative zero" rejected
  3. reject small-order A or R by comparing the raw 32-byte encodings with
     the derived 11-entry blocklist (golden.small_order_blocklist)
  4. k = SHA512(R || A || M) mod L
  5. accept iff [k](-A) + [s]B == R   (cofactorless)

Steps 1, 3 and 4's reduction and digit recoding are plain PyTorch (the
prologue); steps 2 and 5 run in the verify_core kernel on the card.  Every
lane pays the same cost; validity is a mask, never control flow.

`verify_batch_digest_rlc` is the batch (RLC) form: one random linear
combination of the whole batch's equations, checked with a bucket MSM
(msm.py), and the strict per-signature path whenever that check fails.

Entry points take `device=None`, meaning the CUDA card; the CPU runs only
when the caller names it, and then verify_core runs its plain version.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ...utils import devices
from ...utils.hotpath import hot_path
from .. import sha512 as _sha
from . import field as F
from . import golden
from . import msm as MSM
from . import point as PT
from . import scalar as SC
from .verify_core import verify_core

_BLOCKLIST = np.stack(
    [np.frombuffer(e, np.uint8) for e in golden.small_order_blocklist()]
)  # (11, 32)
_BLOCKLIST_ON: dict = {}


def _is_small_order_enc(b):
    """(B, 32) uint8 -> (B,) bool: encoding is on the small-order blocklist."""
    bl = _BLOCKLIST_ON.get(b.device)
    if bl is None:
        bl = _BLOCKLIST_ON[b.device] = torch.from_numpy(_BLOCKLIST).to(b.device)
    return torch.any(torch.all(b[:, None, :] == bl[None, :, :], dim=-1), dim=1)


def prologue(digest, sigs, pubs):
    """Steps 1, 3 and the digit recoding: -> (ok (B,), k digits, s digits,
    a_y, a_sign, r_y, r_sign), the inputs of verify_core."""
    s_limbs = SC.from_bytes(sigs[:, 32:])
    ok = SC.is_canonical(s_limbs)
    ok = ok & ~_is_small_order_enc(pubs) & ~_is_small_order_enc(sigs[:, :32])
    k_digits = SC.to_signed_digits(SC.reduce512(digest))
    s_digits = SC.to_signed_digits(s_limbs)
    a_y, a_sign = PT.decompress_bytes(pubs)
    r_y, r_sign = PT.decompress_bytes(sigs[:, :32])
    return ok, k_digits, s_digits, a_y, a_sign, r_y, r_sign


@hot_path
def _verify_from_digest(digest, sigs, pubs):
    """Steps 1-3 and 5 for tensors on one device; `digest` is
    SHA512(R || A || M) per lane.  On the card steps 2 and 5 are the
    verify_core kernel; there is no plain branch there."""
    ok, *core_in = prologue(digest, sigs, pubs)
    return ok & verify_core(*core_in)


def _bytes_on(dev, *arrays):
    return [devices.as_tensor(a, torch.uint8, dev) for a in arrays]


def message_digests(msgs, lens, sigs, pubs):
    """Step 4's hash on the device: SHA512(R || A || M) per lane."""
    cat = torch.cat([sigs[:, :32], pubs, msgs], dim=1)
    return _sha.sha512(cat, lens + 64)


@hot_path
def verify_batch(msgs, lens, sigs, pubs, device=None):
    """Verify a batch of Ed25519 signatures.

    msgs: (B, max_len) uint8, zero-padded; lens: (B,) byte counts;
    sigs: (B, 64) uint8; pubs: (B, 32) uint8 (numpy arrays or tensors).
    Returns (B,) bool on `device` (default: the CUDA card)."""
    dev = devices.resolve(device)
    msgs, sigs, pubs = _bytes_on(dev, msgs, sigs, pubs)
    lens = devices.as_tensor(lens, torch.int64, dev)
    digest = message_digests(msgs, lens, sigs, pubs)
    return _verify_from_digest(digest, sigs, pubs)


@hot_path
def verify_batch_digest(digests, sigs, pubs, device=None):
    """Verify from precomputed k-digests = SHA512(R || A || M).

    digests: (B, 64); sigs: (B, 64); pubs: (B, 32) uint8.  Returns (B,)
    bool on `device` (default: the CUDA card)."""
    digests, sigs, pubs = _bytes_on(devices.resolve(device), digests, sigs, pubs)
    return _verify_from_digest(digests, sigs, pubs)


def verify_batch_digest_on(device):
    """verify_batch_digest pinned to one device: a callable for a verify
    tile's per-card pool.  An int or "cuda:i" names card i; the inputs are
    copied there and the kernel runs on that card's current stream."""
    if isinstance(device, int):
        device = torch.device("cuda", device)
    dev = devices.resolve(device)

    def fn(digests, sigs, pubs):
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            return verify_batch_digest(digests, sigs, pubs, device=dev)

    fn.device = dev
    return fn


# ---------------------------------------------------------------------------
# Batch (RLC) verification
# ---------------------------------------------------------------------------


def _z_limbs(zbytes):
    """(B, 16) uint8 random z -> (10, B) 13-bit limbs (128 -> 130 bits)."""
    padded = torch.cat([zbytes, torch.zeros_like(zbytes)], dim=-1)
    return F.from_bytes(padded)[:10]


def _signed_digits_of_int(n: int) -> np.ndarray:
    """Host-side signed radix-16 recode (the plain-int analog of
    scalar.to_signed_digits) for scalar constants."""
    digs = []
    for _ in range(64):
        d = n & 15
        n >>= 4
        if d >= 8:
            d -= 16
            n += 1
        digs.append(d)
    assert n == 0, "scalar exceeds 64 signed radix-16 digits"
    return np.array(digs, np.int32).reshape(64, 1)


_L_DIGITS = _signed_digits_of_int(golden.L)


def _torsion_free(y, sign):
    """(N,) bool: each point, given as its y limbs (20, N) and sign (1, N),
    decompresses and lies in the prime-order subgroup ([L]P == identity).

    One verify_core call: [k](-P) + [s]B == R with k = L, s = 0 and R the
    identity's encoding (y = 1, sign 0) is exactly [L](-P) == identity, and
    eq_external against the decompressed identity (0, 1) is eq_points with
    the identity.  Lanes whose P fails to decompress come out False.

    Why the RLC path needs this: the batch equation weights each R_i by its
    odd z_i, and odd weights never separate order-2 torsion: two signatures
    built on R' = R + T2 have residual T2 each, and z1 T2 + z2 T2 = identity
    for every odd pair.  Mixed-order points are the only source of torsion
    residuals; restricting the accept path to subgroup points removes the
    component, after which random-z soundness is the prime-order argument."""
    n = y.shape[-1]
    ldig = torch.from_numpy(_L_DIGITS).to(y.device).expand(64, n).contiguous()
    zero = torch.zeros((64, n), dtype=torch.int32, device=y.device)
    one_y = F.c("ONE", y.device).expand(F.NLIMB, n).contiguous()
    zsign = torch.zeros((1, n), dtype=torch.int32, device=y.device)
    return verify_core(ldig, zero, y, sign, one_y, zsign)


def _torsion_free_pair(a_y, a_sign, r_y, r_sign):
    """(B,) bool: BOTH A_i and R_i subgroup-checked in one verify_core call
    over the 2B stacked points.  See _torsion_free."""
    tf = _torsion_free(torch.cat([a_y, r_y], dim=-1),
                       torch.cat([a_sign, r_sign], dim=-1))
    b = a_y.shape[-1]
    return tf[:b] & tf[b:]


@hot_path
def rlc_prologue(digests, sigs, pubs, zbytes):
    """The batch path's per-lane work before the MSM: -> dict with ok (B,),
    the MSM's inputs cdig (64, B), zdig (33, B), an3, rn3 (3NL, B) (zero
    digits and identity niels on lanes that fail the prologue), udig
    (64, 1), and the subgroup gate's inputs a_y, a_sign, r_y, r_sign."""
    s_limbs = SC.from_bytes(sigs[:, 32:])
    ok = SC.is_canonical(s_limbs)
    ok = ok & ~_is_small_order_enc(pubs) & ~_is_small_order_enc(sigs[:, :32])
    a_y, a_sign = PT.decompress_bytes(pubs)
    r_y, r_sign = PT.decompress_bytes(sigs[:, :32])
    an3_raw, rn3_raw, dc_ok = MSM.decompress_niels(a_y, a_sign, r_y, r_sign)
    ok = ok & dc_ok
    okm = ok[None, :]

    k_limbs = SC.reduce512(digests)
    z10 = _z_limbs(zbytes)
    c_limbs = SC.mulmod(z10, k_limbs)  # z*k mod L
    z20 = torch.cat([z10, torch.zeros_like(z10)], dim=0)
    cdig = torch.where(okm, SC.to_signed_digits(c_limbs), 0)
    zdig = torch.where(okm, SC.to_signed_digits(z20)[: MSM.ZWIN], 0)

    su = torch.where(okm, SC.mulmod(z10, s_limbs), 0)
    udig = SC.to_signed_digits(SC.summod(su))  # sum z_i s_i mod L, (64, 1)

    ident = torch.cat(PT.identity_niels_affine(ok.shape[0], ok.device), dim=0)
    return dict(
        ok=ok, cdig=cdig, zdig=zdig, udig=udig,
        an3=torch.where(okm, an3_raw, ident), rn3=torch.where(okm, rn3_raw, ident),
        a_y=a_y, a_sign=a_sign, r_y=r_y, r_sign=r_sign,
    )


def _verify_digest_rlc_impl(digests, sigs, pubs, zbytes):
    """Batch (RLC) verification: -> (lane_ok (B,), batch_ok () bool).

    lane_ok is the per-lane prologue verdict (canonical s, small-order
    blocklist, decompress); batch_ok is the one RLC group equation over the
    lanes that passed the prologue AND the prime-order subgroup check of
    every included A and R (_torsion_free_pair).  The gate runs only when
    the equation holds: a failed equation already sends the batch to the
    strict path.  Accept lane i iff batch_ok & lane_ok[i]; on !batch_ok the
    caller runs the strict per-signature path.  Lanes that fail the
    prologue have zero digits and identity niels, so they cannot poison the
    equation."""
    p = rlc_prologue(digests, sigs, pubs, zbytes)
    batch_ok = MSM.msm_check(p["cdig"], p["zdig"], p["an3"], p["rn3"], p["udig"])
    if bool(batch_ok):
        tf = _torsion_free_pair(p["a_y"], p["a_sign"], p["r_y"], p["r_sign"])
        batch_ok = batch_ok & torch.all(tf | ~p["ok"])
    return p["ok"], batch_ok


def verify_batch_digest_rlc(digests, sigs, pubs, zbytes=None, device=None):
    """Batch-verify from precomputed k-digests: the RLC equation accepts
    the batch, and whenever it fails the strict per-signature path
    (verify_batch_digest) decides every lane.

    zbytes: (B, 16) uint8 per-batch secret randomness; None draws it from
    os.urandom (a seeded generator would let an attacker predict z).  z is
    forced odd here.  Returns (B,) bool on `device` (default: the CUDA
    card)."""
    dev = devices.resolve(device)
    digests, sigs, pubs = _bytes_on(dev, digests, sigs, pubs)
    B = sigs.shape[0]
    if zbytes is None:
        zbytes = np.frombuffer(bytearray(os.urandom(16 * B)), np.uint8).reshape(B, 16)
    zbytes = devices.as_tensor(zbytes, torch.uint8, dev).clone()
    zbytes[:, 0] |= 1  # odd z: no 8-torsion residual survives one lane
    lane_ok, batch_ok = _verify_digest_rlc_impl(digests, sigs, pubs, zbytes)
    if bool(batch_ok):
        return lane_ok
    return _verify_from_digest(digests, sigs, pubs)
