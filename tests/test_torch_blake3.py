"""The port's batched BLAKE3 against an independent pure-Python BLAKE3 of
one chunk (written from the specification), the published empty-input
digest, and the JAX blake3.  Digests are compared exactly.

The JAX single-chunk function compiles for many minutes on a CPU (16
unrolled blocks of 7 rounds), so the comparison runs it op by op under
`jax.disable_jit()` (seconds)."""

import jax
import numpy as np
import pytest

from firedancer_tpu.ops import blake3 as BJ
from firedancer_tpu_torch.ops import blake3 as BT

EMPTY = "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"
LENGTHS = [0, 1, 63, 64, 65, 128, 500, 1023, 1024]
M32 = 0xFFFFFFFF


def _ref_compress(cv, block, blen, flags):
    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M32

    m = [int.from_bytes(block[4 * i:4 * i + 4], "little") for i in range(16)]
    v = list(cv) + BT.IV[:4] + [0, 0, blen, flags]

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & M32
        v[d] = rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & M32
        v[b] = rotr(v[b] ^ v[c], 12)
        v[a] = (v[a] + v[b] + y) & M32
        v[d] = rotr(v[d] ^ v[a], 8)
        v[c] = (v[c] + v[d]) & M32
        v[b] = rotr(v[b] ^ v[c], 7)

    for r in range(7):
        for i, (a, b, c, d) in enumerate([(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14),
                                          (3, 7, 11, 15), (0, 5, 10, 15), (1, 6, 11, 12),
                                          (2, 7, 8, 13), (3, 4, 9, 14)]):
            g(a, b, c, d, m[2 * i], m[2 * i + 1])
        m = [m[p] for p in (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)]
    return [v[i] ^ v[i + 8] for i in range(8)]


def _ref_blake3(data: bytes) -> bytes:
    """BLAKE3 of at most one chunk: blocks of 64 bytes, CHUNK_START on the
    first, CHUNK_END | ROOT on the last."""
    assert len(data) <= 1024
    blocks = [data[i:i + 64] for i in range(0, len(data), 64)] or [b""]
    cv = list(BT.IV)
    for j, blk in enumerate(blocks):
        flags = (1 if j == 0 else 0) | (2 | 8 if j == len(blocks) - 1 else 0)
        cv = _ref_compress(cv, blk.ljust(64, b"\0"), len(blk), flags)
    return b"".join(w.to_bytes(4, "little") for w in cv)


def _batch(seed, lengths, width):
    rng = np.random.default_rng(seed)
    lens = np.array(lengths, np.int32)
    msgs = rng.integers(0, 256, (len(lens), width), np.uint8)
    msgs[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msgs, lens


def test_empty_input_vector():
    assert _ref_blake3(b"").hex() == EMPTY
    got = BT.blake3(np.zeros((1, 0), np.uint8), np.zeros(1, np.int32), device="cpu")
    assert got.numpy()[0].tobytes().hex() == EMPTY


@pytest.mark.parametrize("width", [1024, 130])
def test_blake3_matches_reference(width):
    msgs, lens = _batch(width, [min(n, width) for n in LENGTHS], width)
    got = BT.blake3(msgs, lens, device="cpu").numpy()
    for i, n in enumerate(lens):
        assert got[i].tobytes() == _ref_blake3(msgs[i, :n].tobytes()), n


def test_blake3_rejects_multi_chunk_width():
    with pytest.raises(ValueError, match="multi-chunk"):
        BT.blake3(np.zeros((1, 1025), np.uint8), np.zeros(1, np.int32), device="cpu")


def test_blake3_matches_jax():
    msgs, lens = _batch(3, LENGTHS, 1024)
    with jax.disable_jit():
        want = np.asarray(BJ.blake3(msgs, lens))
    np.testing.assert_array_equal(BT.blake3(msgs, lens, device="cpu").numpy(), want)
    with pytest.raises(AssertionError):
        BJ.blake3(np.zeros((1, 1025), np.uint8), np.zeros(1, np.int32))
