"""Batched SHA-512 in plain PyTorch over int64 words.

The counterpart of firedancer_tpu/ops/sha512.py: one digest per lane, the
batch axis is the vector axis.  Where the JAX module carries each 64-bit word
as a (hi, lo) uint32 pair, this one keeps it in one int64 lane: additions
wrap mod 2^64 in two's complement exactly as unsigned words do, and a logical
right shift is an arithmetic shift with the sign-extended bits masked off.

Entry point: sha512(msgs, lens) -> (B, 64) uint8 digests, where msgs is a
(B, max_len) uint8 tensor and lens the per-lane byte counts.  The block loop
runs ceil((max_len+17)/128) compressions with per-lane masking, so every lane
costs the same as the longest possible message.
"""

from __future__ import annotations

import torch

from ..utils.shaconst import H64 as _H64
from ..utils.shaconst import K64 as _K64


def _signed(v: int) -> int:
    """Unsigned 64-bit python int -> the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


_K = [_signed(k) for k in _K64]
_H = torch.tensor([_signed(h) for h in _H64], dtype=torch.int64)


def _shr(x, n: int):
    """Logical right shift of int64 words by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x, n: int):
    return _shr(x, n) | (x << (64 - n))


def _compress(state, w):
    """One SHA-512 compression.  state: (B, 8) int64; w: (B, 16) int64."""
    a, b, c, d, e, f, g, h = state.unbind(1)
    ws = list(w.unbind(1))
    for t in range(80):
        if t >= 16:
            w15, w2 = ws[t - 15], ws[t - 2]
            s0 = _rotr(w15, 1) ^ _rotr(w15, 8) ^ _shr(w15, 7)
            s1 = _rotr(w2, 19) ^ _rotr(w2, 61) ^ _shr(w2, 6)
            ws.append(ws[t - 16] + s0 + ws[t - 7] + s1)
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K[t] + ws[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + s0 + maj
    return state + torch.stack([a, b, c, d, e, f, g, h], dim=1)


def _pad(msgs, lens, max_blocks: int):
    """(B, max_blocks*128) uint8 padded buffer and (B,) block counts."""
    bsz, width = msgs.shape
    total = max_blocks * 128
    buf = torch.zeros((bsz, total), dtype=torch.uint8, device=msgs.device)
    buf[:, :width] = msgs
    pos = torch.arange(total, device=msgs.device)[None, :]
    lens_c = lens.to(torch.int64)[:, None]
    buf = torch.where(pos < lens_c, buf, torch.zeros_like(buf))
    buf = torch.where(pos == lens_c, torch.full_like(buf, 0x80), buf)
    # 128-bit big-endian bit length ends the lane's last block; only its
    # low 8 bytes can be nonzero for any message < 2^61 bytes
    nblocks = (lens_c + 17 + 127) // 128
    pfe = pos - (nblocks * 128 - 8)
    in_len = (pfe >= 0) & (pfe < 8)
    shift = (8 * (7 - pfe)).clamp(0, 63)
    len_byte = ((lens_c * 8) >> shift) & 0xFF
    buf = torch.where(in_len, len_byte.to(torch.uint8), buf)
    return buf, nblocks[:, 0]


def sha512(msgs, lens):
    """Batch SHA-512.  msgs: (B, max_len) uint8 tensor; lens: (B,) integer
    tensor on the same device.  -> (B, 64) uint8 digests.

    Precondition: 0 <= lens[j] <= max_len for every lane (a lane that
    breaks it gets a well-formed but wrong digest)."""
    bsz, max_len = msgs.shape
    max_blocks = (max_len + 17 + 127) // 128
    buf, nblocks = _pad(msgs, lens, max_blocks)
    # big-endian 64-bit words: (B, max_blocks, 16)
    by = buf.reshape(bsz, max_blocks, 16, 8).to(torch.int64)
    words = by[..., 0] << 56
    for j in range(1, 8):
        words = words | (by[..., j] << (8 * (7 - j)))
    state = _H.to(msgs.device).expand(bsz, 8)
    for blk in range(max_blocks):
        nxt = _compress(state, words[:, blk])
        state = torch.where((blk < nblocks)[:, None], nxt, state)
    # big-endian serialize
    shifts = torch.arange(56, -8, -8, device=msgs.device)
    out = (state[:, :, None] >> shifts) & 0xFF
    return out.reshape(bsz, 64).to(torch.uint8)
