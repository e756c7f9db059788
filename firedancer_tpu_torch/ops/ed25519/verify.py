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

Entry points take `device=None`, meaning the CUDA card; the CPU runs only
when the caller names it, and then verify_core runs its plain version.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ...utils import devices
from .. import sha512 as _sha
from . import golden
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
