"""Batched Keccak-256 (the sol_keccak256 syscall hash) in plain PyTorch:
the counterpart of firedancer_tpu/ops/keccak256.py.

Behavior contract: src/ballet/keccak256/ (Keccak-f[1600], rate 136,
output 32 bytes, 0x01 domain padding: "legacy" Keccak as used by
Ethereum and Solana, not NIST SHA-3's 0x06).

The JAX module carries each 64-bit lane of the 5x5 state as an (hi, lo)
uint32 pair.  Here a lane is one int64 (the bits of the unsigned lane), the
state a (25, B) tensor with lane x + 5y at row x + 5y, and each step of a
round runs on the whole state at once: theta's column parities over the
(5, 5, B) view, rho's rotations with per-lane shift tensors (a left shift
OR a masked logical right shift, as ops/sha512.py's `_shr`), pi as one
gather, chi as rolls along x.  About two dozen launches per round.

Entry points: keccak256(msgs, lens, device=None) -> (B, 32) uint8 on the
device (None: the CUDA card), and digest_host(data) for one message on the
host: a pure-Python copy of the JAX module's host digest, kept here because
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import torch

from ..utils import devices
from .sha512 import _signed

RATE = 136  # bytes; capacity 512 bits -> 256-bit output

# ---------------------------------------------------------------------------
# host-side single-message digest (VM syscall path: arbitrary lengths;
# plain python ints)
# ---------------------------------------------------------------------------

_ROTC = (1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
         27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44)
_PILN = (10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
         15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1)
_M64 = (1 << 64) - 1


def _rc_host():
    # round constants from the degree-8 LFSR (derived, not pasted)
    out = []
    r = 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if r & 1:
                rc ^= 1 << ((1 << j) - 1)
            r = ((r << 1) ^ (0x71 if r & 0x80 else 0)) & 0xFF
        out.append(rc)
    return out


_RC_HOST = _rc_host()


def _permute_host(st: list[int]) -> None:
    for rc in _RC_HOST:
        # theta
        bc = [st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20]
              for i in range(5)]
        for i in range(5):
            t = bc[(i + 4) % 5] ^ (
                ((bc[(i + 1) % 5] << 1) | (bc[(i + 1) % 5] >> 63)) & _M64
            )
            for j in range(0, 25, 5):
                st[i + j] ^= t
        # rho + pi
        t = st[1]
        for i in range(24):
            j = _PILN[i]
            bc0 = st[j]
            r = _ROTC[i]
            st[j] = ((t << r) | (t >> (64 - r))) & _M64
            t = bc0
        # chi
        for j in range(0, 25, 5):
            row = st[j : j + 5]
            for i in range(5):
                st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5])
        st[0] ^= rc


def digest_host(data: bytes) -> bytes:
    """Keccak-256 of one message, host-side (VM syscall use)."""
    rate = 136
    st = [0] * 25
    # pad10*1: when only one pad byte fits, 0x01 and 0x80 merge into 0x81
    q = rate - len(data) % rate
    if q == 1:
        padded = data + b"\x81"
    else:
        padded = data + b"\x01" + b"\x00" * (q - 2) + b"\x80"
    for off in range(0, len(padded), rate):
        blk = padded[off : off + rate]
        for i in range(rate // 8):
            st[i] ^= int.from_bytes(blk[8 * i : 8 * i + 8], "little")
        _permute_host(st)
    return b"".join(st[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------------
# batched device form
# ---------------------------------------------------------------------------

# rotation of lane x + 5y (rho), and where pi moves it: B[y, 2x + 3y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


_R = [_ROT[i % 5][i // 5] for i in range(25)]
_R_LEFT = torch.tensor(_R, dtype=torch.int64)[:, None]
_R_RIGHT = torch.tensor([(64 - r) % 64 for r in _R], dtype=torch.int64)[:, None]
_R_MASK = torch.tensor([(1 << r) - 1 for r in _R], dtype=torch.int64)[:, None]
_DST = [i // 5 + 5 * ((2 * (i % 5) + 3 * (i // 5)) % 5) for i in range(25)]
#: pi as a gather: row j of the permuted state comes from row _PI_SRC[j]
_PI_SRC = torch.tensor([_DST.index(j) for j in range(25)], dtype=torch.int64)
_RC = [_signed(rc) for rc in _RC_HOST]


def _rotl1(x):
    return (x << 1) | ((x >> 63) & 1)


def _permute(s):
    """Keccak-f[1600] on a (25, B) int64 state."""
    dev = s.device
    r_left, r_right, r_mask = (_R_LEFT.to(dev), _R_RIGHT.to(dev), _R_MASK.to(dev))
    pi_src = _PI_SRC.to(dev)
    for rc in _RC:
        s5 = s.reshape(5, 5, -1)  # [y][x]
        c = s5[0] ^ s5[1] ^ s5[2] ^ s5[3] ^ s5[4]
        d = c.roll(1, dims=0) ^ _rotl1(c.roll(-1, dims=0))
        s = (s5 ^ d[None]).reshape(25, -1)
        s = ((s << r_left) | ((s >> r_right) & r_mask))[pi_src]
        b5 = s.reshape(5, 5, -1)
        s = (b5 ^ (~b5.roll(-1, dims=1) & b5.roll(-2, dims=1))).reshape(25, -1)
        s[0] ^= rc
    return s


def keccak256(msgs, lens, device=None):
    """Batched Keccak-256.  msgs: (B, W) uint8, zero-padded; lens: (B,)
    byte counts (numpy arrays or tensors) -> (B, 32) uint8 on `device`."""
    dev = devices.resolve(device)
    msgs = devices.as_tensor(msgs, torch.uint8, dev)
    lens = devices.as_tensor(lens, torch.int64, dev)
    bsz, width = msgs.shape
    n_blocks = width // RATE + 1  # padding always adds at most one block
    padded = n_blocks * RATE
    buf = torch.zeros((bsz, padded), dtype=torch.uint8, device=dev)
    buf[:, :width] = msgs
    col = torch.arange(padded, device=dev)[None, :]
    buf = torch.where(col < lens[:, None], buf, torch.zeros_like(buf))
    # 0x01 at lens, 0x80 on the last byte of the lane's final block (the
    # two may coincide: 0x81)
    buf = torch.where(col == lens[:, None], torch.ones_like(buf), buf)
    last = (lens // RATE + 1) * RATE - 1
    buf = torch.where(col == last[:, None], buf | 0x80, buf)
    by = buf.reshape(bsz, n_blocks, RATE // 8, 8).to(torch.int64)
    words = by[..., 0]
    for j in range(1, 8):
        words = words | (by[..., j] << (8 * j))  # little-endian lanes
    n_active = lens // RATE + 1
    s = torch.zeros((25, bsz), dtype=torch.int64, device=dev)
    for blk in range(n_blocks):
        absorbed = s.clone()
        absorbed[: RATE // 8] ^= words[:, blk].T
        s = torch.where((blk < n_active)[None, :], _permute(absorbed), s)
    shifts = torch.arange(0, 64, 8, device=dev)
    out = (s[:4].T[..., None] >> shifts) & 0xFF
    return out.reshape(bsz, 32).to(torch.uint8)
