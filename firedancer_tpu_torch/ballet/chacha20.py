"""ChaCha20 block function + the Solana-compatible ChaCha20Rng.

A copy of firedancer_tpu/ballet/chacha20.py (the admission layer's
StakeTable.synthetic draws its weights from ChaCha20Rng).

Behavior contract: src/ballet/chacha20/fd_chacha20.c (block layout:
constants | key | counter-word | 3 nonce words) and fd_chacha20rng.h —
a rand_chacha-compatible RNG: the stream is successive 64-byte blocks
with the block index in the counter word, reads are 8-byte little-endian,
and ulong_roll is the widening-multiply rejection sampler with two zone
modes (MODE_MOD for leader schedule, MODE_SHIFT for Turbine).

Host-side: this seeds leader schedules and Turbine trees, not the packet
path.  The block function is vectorized numpy so a whole buffer of
blocks is produced per call.
"""

from __future__ import annotations

import numpy as np

MODE_MOD = 1
MODE_SHIFT = 2

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl32(x, n):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(s, a, b, c, d):
    with np.errstate(over="ignore"):
        s[a] += s[b]
        s[d] = _rotl32(s[d] ^ s[a], 16)
        s[c] += s[d]
        s[b] = _rotl32(s[b] ^ s[c], 12)
        s[a] += s[b]
        s[d] = _rotl32(s[d] ^ s[a], 8)
        s[c] += s[d]
        s[b] = _rotl32(s[b] ^ s[c], 7)


def chacha20_blocks(key: bytes, counters: np.ndarray, nonce: bytes = b"\0" * 12) -> np.ndarray:
    """ChaCha20 keystream blocks for a batch of counter values.

    key: 32 bytes; counters: (N,) uint32; nonce: 12 bytes.
    Returns (N, 64) uint8."""
    assert len(key) == 32 and len(nonce) == 12
    n = len(counters)
    kw = np.frombuffer(key, dtype="<u4")
    nw = np.frombuffer(nonce, dtype="<u4")
    state = np.zeros((16, n), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = kw[:, None]
    state[12] = np.asarray(counters, np.uint32)
    state[13:16] = nw[:, None]
    s = state.copy()
    for _ in range(10):  # 20 rounds = 10 double rounds
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    with np.errstate(over="ignore"):
        s += state
    return np.ascontiguousarray(s.T).view(np.uint8).reshape(n, 64)


def chacha20_encrypt(key: bytes, counter0: int, nonce: bytes, data: bytes) -> bytes:
    """IETF ChaCha20 (RFC 8439) encrypt/decrypt (XOR keystream)."""
    n_blocks = (len(data) + 63) // 64
    ks = chacha20_blocks(
        key, np.arange(counter0, counter0 + n_blocks, dtype=np.uint32), nonce
    ).reshape(-1)[: len(data)]
    return bytes(np.frombuffer(data, np.uint8) ^ ks)


class ChaCha20Rng:
    """rand_chacha-compatible RNG (fd_chacha20rng semantics)."""

    BUF_BLOCKS = 8

    def __init__(self, key: bytes, mode: int = MODE_MOD):
        assert len(key) == 32
        self.key = key
        self.mode = mode
        self._buf = np.zeros(0, dtype=np.uint8)
        self._off = 0
        self._next_block = 0

    def _refill(self) -> None:
        idxs = np.arange(
            self._next_block, self._next_block + self.BUF_BLOCKS, dtype=np.uint32
        )
        self._buf = chacha20_blocks(self.key, idxs).reshape(-1)
        self._next_block += self.BUF_BLOCKS
        self._off = 0

    def next_u64(self) -> int:
        if self._off + 8 > len(self._buf):
            self._refill()
        v = int(self._buf[self._off : self._off + 8].view("<u8")[0])
        self._off += 8
        return v

    def roll(self, n: int) -> int:
        """Uniform in [0, n) via widening-multiply rejection
        (fd_chacha20rng_ulong_roll)."""
        assert 0 < n < 1 << 64
        if self.mode == MODE_MOD:
            zone = (1 << 64) - 1 - ((1 << 64) - n) % n
        else:
            zone = (n << (63 - (n.bit_length() - 1))) - 1
        while True:
            v = self.next_u64()
            res = v * n
            hi, lo = res >> 64, res & ((1 << 64) - 1)
            if lo <= zone:
                return hi
