"""Batched Ed25519 signing, the load generator's corpus factory: the
counterpart of firedancer_tpu/ops/ed25519/sign.py.

The one expensive step, the fixed-base scalar multiplication [r]B, runs on
the device as one batched Strauss loop over point.py's plain-torch ops
(64 steps of four doublings and one affine niels addition against the
shared base table); the cheap RFC 8032 bookkeeping (secret expansion,
SHA-512 of prefix and message, S = r + k a mod L) stays on the host.  One
device run signs a whole corpus of distinct keys and messages.  Single
signatures keep using golden.sign or hostpath.sign.

Entry points take `device=None`, meaning the CUDA card.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ...utils import devices
from ...utils.hotpath import hot_path
from . import golden
from . import point as PT
from . import scalar as SC


@hot_path
def _base_mul_compress(r_bytes):
    """(B, 32) uint8 little-endian scalars (< L) -> (B, 32) uint8 compressed
    [r]B: point.scalar_mul_base over the signed radix-16 digits, then one
    batched inversion."""
    return PT.compress(PT.scalar_mul_base(SC.to_signed_digits(SC.from_bytes(r_bytes))))


def _scalars(values, dev):
    arr = np.zeros((len(values), 32), np.uint8)
    for i, v in enumerate(values):
        arr[i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    return torch.from_numpy(arr).to(dev)


def _base_mul_bytes(values, dev) -> list[bytes]:
    if not values:
        return []
    out =_base_mul_compress(_scalars(values, dev)).cpu().numpy()
    return [out[i].tobytes() for i in range(len(values))]


def public_keys(secrets: list[bytes], device=None) -> list[bytes]:
    """Batch [a]B public-key derivation: one device run for every key."""
    dev = devices.resolve(device)
    # clamped scalars exceed L; the digit recoding expects canonical
    # scalars, and [a mod L]B == [a]B (L divides B's order)
    return _base_mul_bytes([golden.secret_expand(s)[0] % golden.L for s in secrets], dev)


def sign_many(pairs: list[tuple[bytes, bytes]],
              pubs: dict[bytes, bytes] | None = None, device=None) -> list[bytes]:
    """Sign (secret, msg) pairs; the keys may all differ, and the [r]B
    multiplication runs as one device run over every lane.

    pubs: optional secret -> public key map; missing keys are derived as
    one device batch.  RFC 8032: r = SHA512(prefix || M) mod L; R = [r]B;
    S = (r + SHA512(R || A || M) * a) mod L.  -> 64-byte signatures."""
    dev = devices.resolve(device)
    pubs = dict(pubs or {})
    unique = list(dict.fromkeys(s for s, _ in pairs if s not in pubs))
    if unique:
        pubs.update(zip(unique, public_keys(unique, device=dev)))
    expanded = {s: golden.secret_expand(s) for s in dict.fromkeys(s for s, _ in pairs)}
    rs = [int.from_bytes(hashlib.sha512(expanded[s][1] + m).digest(), "little") % golden.L
          for s, m in pairs]
    big_r = _base_mul_bytes(rs, dev)
    sigs = []
    for (secret, m), r, rb in zip(pairs, rs, big_r):
        k = int.from_bytes(hashlib.sha512(rb + pubs[secret] + m).digest(), "little") % golden.L
        sigs.append(rb + ((r + k * expanded[secret][0]) % golden.L).to_bytes(32, "little"))
    return sigs


def sign_batch(secret: bytes, msgs: list[bytes], device=None) -> list[bytes]:
    """Sign every message with one key (see sign_many)."""
    return sign_many([(secret, m) for m in msgs],
                     pubs={secret: golden.public_from_secret(secret)}, device=device)
