"""AES-128/256 + AES-GCM, NumPy-vectorized over blocks.

A copy of firedancer_tpu/ballet/aes.py; it stays numpy on the host.

The reference implements AES-GCM for QUIC packet protection with AES-NI +
GFNI assembly (src/ballet/aes/, behavior contract only).
TPU-native reality check: QUIC packet protection is control-plane work that
runs on the HOST next to the sockets — per-packet serial latency matters,
not batch throughput — so the right "native" here is vectorized NumPy over
the blocks of each packet (the block cipher rounds apply to all blocks of a
packet at once), not a device kernel.  GHASH uses 8-bit Shoup tables
(python ints) — the per-key 4 KB table mirrors the reference's gfni table
strategy at a scripting-language scale.

Tests cross-check against NIST CAVP-style vectors and the system
`cryptography` package.
"""

from __future__ import annotations

import hmac

import numpy as np

# ---------------------------------------------------------------------------
# S-box generation (derived, not pasted: multiplicative inverse + affine map)
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
    return r


def _build_sbox() -> np.ndarray:
    inv = [0] * 256
    for i in range(1, 256):
        for j in range(1, 256):
            if _gf_mul(i, j) == 1:
                inv[i] = j
                break
    sbox = np.zeros(256, np.uint8)
    for i in range(256):
        x = inv[i]
        y = x
        for _ in range(4):
            y = ((y << 1) | (y >> 7)) & 0xFF
            x ^= y
        sbox[i] = x ^ 0x63
    return sbox


SBOX = _build_sbox()
XTIME = np.array(
    [((i << 1) ^ (0x1B if i & 0x80 else 0)) & 0xFF for i in range(256)],
    np.uint8,
)
_RCON = [1]
while len(_RCON) < 14:
    _RCON.append(_gf_mul(_RCON[-1], 2))

# ShiftRows permutation on the 16-byte column-major state (byte i = state
# row i%4, col i//4; AES shifts row r left by r columns)
_SHIFT = np.array(
    [(i + 4 * (i % 4)) % 16 for i in range(16)], np.int64
)


def key_expand(key: bytes) -> np.ndarray:
    """AES-128/256 key schedule -> (rounds+1, 16) u8 round keys."""
    nk = len(key) // 4
    assert nk in (4, 8), "AES-128 or AES-256 only"
    rounds = {4: 10, 8: 14}[nk]
    w = [list(key[4 * i : 4 * i + 4]) for i in range(nk)]
    for i in range(nk, 4 * (rounds + 1)):
        t = list(w[i - 1])
        if i % nk == 0:
            t = t[1:] + t[:1]
            t = [int(SBOX[b]) for b in t]
            t[0] ^= _RCON[i // nk - 1]
        elif nk == 8 and i % nk == 4:
            t = [int(SBOX[b]) for b in t]
        w.append([a ^ b for a, b in zip(w[i - nk], t)])
    ks = np.array(w, np.uint8).reshape(rounds + 1, 16)
    return ks


def encrypt_blocks(ks: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """(n, 16) u8 plaintext blocks -> (n, 16) u8 ciphertext, vectorized."""
    rounds = ks.shape[0] - 1
    s = blocks ^ ks[0]
    for r in range(1, rounds + 1):
        s = SBOX[s]
        s = s[:, _SHIFT]
        if r != rounds:
            # MixColumns on column-major quads
            a = s.reshape(-1, 4, 4)
            x = XTIME[a]
            b = np.empty_like(a)
            t = a[:, :, 0] ^ a[:, :, 1] ^ a[:, :, 2] ^ a[:, :, 3]
            b[:, :, 0] = a[:, :, 0] ^ t ^ XTIME[a[:, :, 0] ^ a[:, :, 1]]
            b[:, :, 1] = a[:, :, 1] ^ t ^ XTIME[a[:, :, 1] ^ a[:, :, 2]]
            b[:, :, 2] = a[:, :, 2] ^ t ^ XTIME[a[:, :, 2] ^ a[:, :, 3]]
            b[:, :, 3] = a[:, :, 3] ^ t ^ XTIME[a[:, :, 3] ^ a[:, :, 0]]
            del x
            s = b.reshape(-1, 16)
        s = s ^ ks[r]
    return s


def encrypt_block(ks: np.ndarray, block: bytes) -> bytes:
    return encrypt_blocks(ks, np.frombuffer(block, np.uint8)[None, :])[
        0
    ].tobytes()


# ---------------------------------------------------------------------------
# GHASH (GF(2^128), Shoup 8-bit tables over python ints)
# ---------------------------------------------------------------------------

_R = 0xE1 << 120


def _gf128_mul(x: int, y: int) -> int:
    """Bit-serial GF(2^128) multiply (table generation only)."""
    z = 0
    v = x
    for i in range(127, -1, -1):
        if (y >> i) & 1:
            z ^= v
        if v & 1:
            v = (v >> 1) ^ _R
        else:
            v >>= 1
    return z


class Ghash:
    """GHASH with a per-key 16x256 table: one lookup+xor per message byte."""

    def __init__(self, h: bytes):
        hi = int.from_bytes(h, "big")
        # The table entry for (pos, b) is H * (b << 8*(15-pos)) in
        # GF(2^128) — LINEAR in the bits of the integer operand.  So
        # instead of 4096 bit-serial multiplies (the per-AesGcm cost
        # that made a pure handshake flood expensive for US, not the
        # attacker), precompute the 128 single-bit products with one
        # conditional reduction step each, then build every row by
        # subset-xor.  Bit j of the operand contributes H halved
        # (127-j) times (the _gf128_mul loop order), so:
        p = [0] * 128
        v = hi
        for j in range(127, -1, -1):
            p[j] = v
            v = (v >> 1) ^ _R if v & 1 else v >> 1
        self.table = []
        for pos in range(16):
            base = 8 * (15 - pos)
            row = [0] * 256
            for b in range(1, 256):
                low = b & -b
                row[b] = row[b ^ low] ^ p[base + low.bit_length() - 1]
            self.table.append(row)

    def _mul_h(self, x: int) -> int:
        t = self.table
        acc = 0
        for pos in range(16):
            acc ^= t[pos][(x >> (8 * (15 - pos))) & 0xFF]
        return acc

    def digest(self, aad: bytes, ct: bytes) -> int:
        x = 0
        for buf in (aad, ct):
            for o in range(0, len(buf), 16):
                blk = buf[o : o + 16].ljust(16, b"\0")
                x = self._mul_h(x ^ int.from_bytes(blk, "big"))
        lens = (len(aad) * 8) << 64 | (len(ct) * 8)
        return self._mul_h(x ^ lens)


# ---------------------------------------------------------------------------
# AES-GCM
# ---------------------------------------------------------------------------


class AesGcm:
    """AES-GCM AEAD (96-bit IV), the QUIC packet-protection cipher."""

    def __init__(self, key: bytes):
        self.ks = key_expand(key)
        self.ghash = Ghash(encrypt_block(self.ks, b"\0" * 16))

    def _ctr(self, iv: bytes, n_blocks: int, ctr0: int) -> np.ndarray:
        ctrs = np.zeros((n_blocks, 16), np.uint8)
        ctrs[:, :12] = np.frombuffer(iv, np.uint8)
        cnt = (ctr0 + np.arange(n_blocks, dtype=np.uint64)).astype(">u4")
        ctrs[:, 12:] = cnt.view(np.uint8).reshape(-1, 4)
        return encrypt_blocks(self.ks, ctrs)

    def _tag(self, iv: bytes, aad: bytes, ct: bytes) -> bytes:
        s = self.ghash.digest(aad, ct)
        ek0 = self._ctr(iv, 1, 1)[0]
        return (
            int.from_bytes(ek0.tobytes(), "big") ^ s
        ).to_bytes(16, "big")

    def _xor_stream(self, iv: bytes, data: bytes) -> bytes:
        n = (len(data) + 15) // 16
        stream = self._ctr(iv, n, 2).reshape(-1)[: len(data)]
        return (np.frombuffer(data, np.uint8) ^ stream).tobytes()

    def encrypt(self, iv: bytes, plaintext: bytes, aad: bytes) -> bytes:
        """Returns ciphertext || 16-byte tag."""
        assert len(iv) == 12
        ct = self._xor_stream(iv, plaintext)
        return ct + self._tag(iv, aad, ct)

    def decrypt(self, iv: bytes, ct_tag: bytes, aad: bytes) -> bytes | None:
        """Returns plaintext, or None on tag mismatch."""
        assert len(iv) == 12
        if len(ct_tag) < 16:
            return None
        ct, tag = ct_tag[:-16], ct_tag[-16:]
        # constant-time compare: the attacker controls ct+tag on the QUIC
        # packet-protection path, so a short-circuit != would leak the
        # matching prefix length
        if not hmac.compare_digest(self._tag(iv, aad, ct), tag):
            return None
        return self._xor_stream(iv, ct)
