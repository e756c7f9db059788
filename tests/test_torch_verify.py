"""The port's verify entry points as a whole (SHA-512, prologue, verify
core) against the JAX package and the golden oracle on the same seeded
lanes: genuine signatures over messages of different lengths, the corrupted
lanes of tests/test_pallas_kernel.py, a non-canonical s, small-order R, and
a non-canonical y.  Results are bools: comparisons are exact."""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import verify as VJ
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
from firedancer_tpu_torch.ops.ed25519 import verify as VT

B, W = 14, 300


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    sks = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(4)]
    msgs = rng.integers(0, 256, (B, W), np.uint8)
    lens = rng.integers(0, W + 1, B).astype(np.int32)
    lens[:3] = [0, W, 111]
    msgs[np.arange(W)[None, :] >= lens[:, None]] = 0  # zero-padded
    sigs = np.zeros((B, 64), np.uint8)
    pubs = np.zeros((B, 32), np.uint8)
    for i in range(B):
        sk = sks[i % 4]
        sigs[i] = np.frombuffer(
            hostpath.sign(sk, msgs[i, : lens[i]].tobytes()), np.uint8)
        pubs[i] = np.frombuffer(hostpath.public_from_secret(sk), np.uint8)
    sigs[3, 3] ^= 0xFF  # bad R
    sigs[4, 40] ^= 0x01  # bad s
    pubs[5] = rng.integers(0, 256, 32, np.uint8)  # wrong key
    msgs[6, 0] ^= 0x80  # bad msg
    pubs[7] = 0
    pubs[7, 0] = 1  # identity key: small order
    s = int.from_bytes(sigs[8, 32:].tobytes(), "little") + golden.L
    sigs[8, 32:] = np.frombuffer(s.to_bytes(32, "little"), np.uint8)  # s >= L
    sigs[9, :32] = np.frombuffer(golden.small_order_blocklist()[3], np.uint8)
    y = next(v for v in (golden.P + k for k in range(2, 19))
             if golden.point_decompress(v.to_bytes(32, "little")))
    pubs[10] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    want_golden = np.array([
        golden.verify(msgs[i, : lens[i]].tobytes(), sigs[i].tobytes(),
                      pubs[i].tobytes()) == 0
        for i in range(B)
    ])
    assert want_golden.tolist() == [True] * 3 + [False] * 8 + [True] * 3
    want_jax = np.asarray(VJ.verify_batch(msgs, lens, sigs, pubs))
    return msgs, lens, sigs, pubs, want_golden, want_jax


def test_jax_reference_matches_golden(corpus):
    *_, want_golden, want_jax = corpus
    np.testing.assert_array_equal(want_jax, want_golden)


def test_verify_batch(corpus):
    msgs, lens, sigs, pubs, want_golden, want_jax = corpus
    got = VT.verify_batch(msgs, lens, sigs, pubs, device="cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), want_golden)


def _digests(msgs, lens, sigs, pubs):
    return np.stack([
        np.frombuffer(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes()
            + msgs[i, : lens[i]].tobytes()).digest(), np.uint8)
        for i in range(len(lens))
    ])


def test_verify_batch_digest(corpus):
    msgs, lens, sigs, pubs, want_golden, want_jax = corpus
    dig = _digests(msgs, lens, sigs, pubs)
    got = VT.verify_batch_digest(dig, sigs, pubs, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want_jax)
    np.testing.assert_array_equal(got.numpy(), want_golden)
    pinned = VT.verify_batch_digest_on("cpu")
    assert pinned.device == torch.device("cpu")
    np.testing.assert_array_equal(pinned(dig, sigs, pubs).numpy(), want_golden)


def test_device_digests_match_hashlib(corpus):
    msgs, lens, sigs, pubs, *_ = corpus
    t = [torch.from_numpy(a) for a in (msgs, sigs, pubs)]
    got = VT.message_digests(t[0], torch.from_numpy(lens).long(), t[1], t[2])
    np.testing.assert_array_equal(got.numpy(), _digests(msgs, lens, sigs, pubs))


def test_small_order_blocklist_matches_jax():
    np.testing.assert_array_equal(VT._BLOCKLIST, VJ._BLOCKLIST)
