"""Batched BLAKE3 in plain PyTorch: the counterpart of the single-chunk
form of firedancer_tpu/ops/blake3.py (reference: src/ballet/blake3/).

Plain hash mode (no key, no derive-key), 32-byte output, inputs of at most
one chunk (W <= 1024 bytes): the chunk's last block carries the ROOT flag.
Wider inputs raise, as the JAX `blake3` asserts; its staged multi-chunk
tree (`_blake3_impl`) has no caller and is not ported.

Words are 32-bit little-endian values carried in int64 lanes and masked
with `& 0xFFFFFFFF` (torch's uint32 has no `+` or `>>` on the CPU).  The
compression keeps the 16-word state as four (4, B) rows, so the four G
functions of a column step run as one set of launches, and the diagonal
step is the same after rolling rows b, c, d by 1, 2, 3.

Entry point: blake3(msgs, lens, device=None) -> (B, 32) uint8 on the device
(None: the CUDA card).
"""

from __future__ import annotations

import torch

from ..utils import devices

M32 = 0xFFFFFFFF
IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

CHUNK_START = 1 << 0
CHUNK_END = 1 << 1
ROOT = 1 << 3

_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

CHUNK_LEN = 1024
BLOCK_LEN = 64

_IV = torch.tensor(IV, dtype=torch.int64)[:, None]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    """The G function on four columns at once: each argument (4, B)."""
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


def _compress(cv, m, counter, block_len, flags):
    """cv: (8, B) words; m: (16, B) words; counter, block_len, flags: (B,)
    -> (8, B), the first half of the compression's output."""
    iv = _IV.to(cv.device)
    a, b = cv[:4], cv[4:]
    c = iv[:4].expand_as(a)
    d = torch.stack([counter & M32, counter >> 32, block_len, flags])
    for r in range(7):
        a, b, c, d = _g(a, b, c, d, m[0:8:2], m[1:8:2])
        a, b, c, d = _g(a, b.roll(-1, 0), c.roll(-2, 0), d.roll(-3, 0),
                        m[8:16:2], m[9:16:2])
        b, c, d = b.roll(1, 0), c.roll(2, 0), d.roll(3, 0)
        if r != 6:
            m = m[_PERM]
    return torch.cat([a ^ c, b ^ d])


def blake3(msgs, lens, device=None):
    """Batched BLAKE3-256.  msgs: (B, W) uint8, zero-padded, W <= 1024;
    lens: (B,) byte counts (numpy arrays or tensors) -> (B, 32) uint8 on
    `device`.  Raises ValueError for W > 1024 (multi-chunk inputs)."""
    dev = devices.resolve(device)
    msgs = devices.as_tensor(msgs, torch.uint8, dev)
    lens = devices.as_tensor(lens, torch.int64, dev)
    bsz, width = msgs.shape
    if width > CHUNK_LEN:
        raise ValueError(f"width {width} > {CHUNK_LEN}: multi-chunk inputs "
                         "are not supported")
    # blocks past ceil(W / 64) are zero and inactive in every lane
    n_blocks = max(1, -(-width // BLOCK_LEN))
    buf = torch.zeros((bsz, n_blocks * BLOCK_LEN), dtype=torch.uint8, device=dev)
    buf[:, :width] = msgs
    col = torch.arange(n_blocks * BLOCK_LEN, device=dev)[None, :]
    buf = torch.where(col < lens[:, None], buf, torch.zeros_like(buf))
    by = buf.reshape(bsz, n_blocks, 16, 4).to(torch.int64)
    words = by[..., 0] | (by[..., 1] << 8) | (by[..., 2] << 16) | (by[..., 3] << 24)
    nb = ((lens + BLOCK_LEN - 1) // BLOCK_LEN).clamp(min=1)
    zero = torch.zeros(bsz, dtype=torch.int64, device=dev)
    cv = _IV.to(dev).expand(8, bsz)
    for blk in range(n_blocks):
        blen = (lens - blk * BLOCK_LEN).clamp(0, BLOCK_LEN)
        last = torch.where(nb - 1 == blk, CHUNK_END | ROOT, 0)
        flags = last + (CHUNK_START if blk == 0 else 0)
        out = _compress(cv, words[:, blk].T, zero, blen, flags)
        cv = torch.where((blk < nb)[None, :], out, cv)
    shifts = torch.tensor([0, 8, 16, 24], device=dev)
    return ((cv.T[..., None] >> shifts) & 0xFF).reshape(bsz, 32).to(torch.uint8)
