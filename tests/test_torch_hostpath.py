"""The port's strict host verify (ops/ed25519/hostpath.py) against the JAX
package's copy and the golden oracle, on the same seeded lanes: valid
signatures, corrupted R, s, key and message, non-canonical s (s + L),
small-order A and R from the blocklist, a non-canonical y, and the `lanes`
cut that skips padding rows."""

import hashlib

import numpy as np
import pytest

from firedancer_tpu.ops.ed25519 import hostpath as HJ
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath

KINDS = ("valid", "bad_r", "bad_s", "wrong_key", "bad_msg", "s_plus_l",
         "small_order_a", "small_order_r", "noncanon_y", "short_sig")


def _lanes(seed):
    rng = np.random.default_rng(seed)
    sk = rng.bytes(32)
    pk = hostpath.public_from_secret(sk)
    blocklist = golden.small_order_blocklist()
    noncanon = next(
        v for v in (golden.P + k for k in range(2, 19))
        if golden.point_decompress(v.to_bytes(32, "little"))
    ).to_bytes(32, "little")
    out = []
    for j, kind in enumerate(KINDS):
        msg = rng.bytes(int(rng.integers(0, 200)))
        sig = bytearray(hostpath.sign(sk, msg))
        pub = pk
        if kind == "bad_r":
            sig[3] ^= 0xFF
        elif kind == "bad_s":
            sig[40] ^= 0x01
        elif kind == "wrong_key":
            pub = hostpath.public_from_secret(rng.bytes(32))
        elif kind == "bad_msg":
            msg = bytes([msg[0] ^ 0x80]) + msg[1:] if msg else b"\x01"
        elif kind == "s_plus_l":
            s = int.from_bytes(sig[32:], "little") + golden.L
            sig[32:] = s.to_bytes(32, "little")
        elif kind == "small_order_a":
            pub = blocklist[j % len(blocklist)]
        elif kind == "small_order_r":
            sig[:32] = blocklist[(j + 3) % len(blocklist)]
        elif kind == "noncanon_y":
            pub = noncanon
        sig = bytes(sig)
        if kind == "short_sig":
            sig = sig[:63]
        out.append((kind, msg, sig, pub))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verify_digest_matches_jax_and_golden(seed):
    for kind, msg, sig, pub in _lanes(seed):
        digest = hashlib.sha512(sig[:32] + pub + msg).digest()
        got = hostpath.verify_digest(digest, sig, pub)
        assert got == HJ.verify_digest(digest, sig, pub), kind
        # golden.verify returns 0 on success, a negative error code otherwise
        assert got == (len(sig) == 64 and golden.verify(msg, sig, pub) == 0), kind
        assert got == (kind == "valid"), kind


def test_verify_batch_digest_host_matches_jax():
    lanes = [lane for lane in _lanes(5) if len(lane[2]) == 64]
    n = len(lanes)
    dg = np.zeros((n + 2, 64), np.uint8)  # two zero padding rows
    sg = np.zeros((n + 2, 64), np.uint8)
    pb = np.zeros((n + 2, 32), np.uint8)
    for i, (_, msg, sig, pub) in enumerate(lanes):
        dg[i] = np.frombuffer(hashlib.sha512(sig[:32] + pub + msg).digest(), np.uint8)
        sg[i] = np.frombuffer(sig, np.uint8)
        pb[i] = np.frombuffer(pub, np.uint8)
    got = hostpath.verify_batch_digest_host(dg, sg, pb)
    np.testing.assert_array_equal(got, HJ.verify_batch_digest_host(dg, sg, pb))
    assert got.tolist() == [k == "valid" for k, *_ in lanes] + [False, False]
    cut = hostpath.verify_batch_digest_host(dg, sg, pb, lanes=1)
    assert cut.tolist() == [True] + [False] * (n + 1)
    np.testing.assert_array_equal(cut, HJ.verify_batch_digest_host(dg, sg, pb, lanes=1))


def test_shamir_matches_jax():
    rng = np.random.default_rng(9)
    a = hostpath._ext(golden.point_neg(golden.B))
    for _ in range(4):
        k, s = (int(rng.integers(0, 1 << 62)) ** 4 % golden.L for _ in range(2))
        got = hostpath._shamir(k, a, s, hostpath._B_EXT)
        want = HJ._shamir(k, HJ._ext(golden.point_neg(golden.B)), s, HJ._B_EXT)
        assert hostpath._compress(got) == HJ._compress(want)


def test_sign_matches_golden_and_jax():
    """hostpath.sign is golden.sign, byte for byte (chip_smoke's sign phase
    holds every card signature against it, and a sample against golden)."""
    rng = np.random.default_rng(41)
    for n in (0, 1, 64, 200, 1232):
        sk = rng.integers(0, 256, 32, np.uint8).tobytes()
        msg = rng.integers(0, 256, n, np.uint8).tobytes()
        sig = hostpath.sign(sk, msg)
        assert sig == golden.sign(sk, msg) == HJ.sign(sk, msg)
        assert hostpath.public_from_secret(sk) == golden.public_from_secret(sk)
