"""The port's ballet/aes.py and ballet/x25519.py against the JAX package's,
byte for byte on seeded keys and messages (exact: every output byte), and
against the public vectors that tests/test_aes_x25519.py and
tests/test_hostile_ingress.py use: NIST GCM (McGrew-Viega test cases 1 and
3) and RFC 7748 section 5.2."""

import numpy as np
import pytest

from firedancer_tpu.ballet import aes as AJ
from firedancer_tpu.ballet import x25519 as XJ
from firedancer_tpu_torch.ballet import aes as A
from firedancer_tpu_torch.ballet import x25519 as X


@pytest.mark.parametrize("klen", [16, 32])
def test_key_schedule_and_blocks_match_jax(klen):
    rng = np.random.default_rng(klen)
    key = rng.integers(0, 256, klen, np.uint8).tobytes()
    ks, ksj = A.key_expand(key), AJ.key_expand(key)
    assert np.array_equal(ks, ksj)
    blocks = rng.integers(0, 256, (37, 16), np.uint8)
    assert A.encrypt_blocks(ks, blocks).tobytes() == AJ.encrypt_blocks(ksj, blocks).tobytes()
    assert A.encrypt_block(ks, blocks[0].tobytes()) == AJ.encrypt_block(ksj, blocks[0].tobytes())


def test_ghash_matches_jax():
    rng = np.random.default_rng(13)
    for _ in range(3):
        h = rng.integers(0, 256, 16, np.uint8).tobytes()
        g, gj = A.Ghash(h), AJ.Ghash(h)
        assert g.table == gj.table
        for n_aad, n_ct in ((0, 0), (5, 16), (16, 33), (20, 97)):
            aad = rng.integers(0, 256, n_aad, np.uint8).tobytes()
            ct = rng.integers(0, 256, n_ct, np.uint8).tobytes()
            assert g.digest(aad, ct) == gj.digest(aad, ct)
        hi = int.from_bytes(h, "big")
        for pos in (0, 7, 15):
            for b in (1, 0x80, 0xFF):
                assert g.table[pos][b] == A._gf128_mul(hi, b << (8 * (15 - pos)))


@pytest.mark.parametrize("klen", [16, 32])
@pytest.mark.parametrize("ptlen,aadlen", [(0, 0), (13, 0), (16, 20), (97, 5), (1200, 40)])
def test_aes_gcm_matches_jax(klen, ptlen, aadlen):
    rng = np.random.default_rng(klen * 1000 + ptlen)
    key = rng.integers(0, 256, klen, np.uint8).tobytes()
    iv = rng.integers(0, 256, 12, np.uint8).tobytes()
    pt = rng.integers(0, 256, ptlen, np.uint8).tobytes()
    aad = rng.integers(0, 256, aadlen, np.uint8).tobytes()
    g = A.AesGcm(key)
    ct = g.encrypt(iv, pt, aad)
    assert ct == AJ.AesGcm(key).encrypt(iv, pt, aad)
    assert g.decrypt(iv, ct, aad) == pt
    bad = ct[:-1] + bytes([ct[-1] ^ 1])
    assert g.decrypt(iv, bad, aad) is None
    assert AJ.AesGcm(key).decrypt(iv, bad, aad) is None
    crypto = pytest.importorskip("cryptography.hazmat.primitives.ciphers.aead")
    assert ct == crypto.AESGCM(key).encrypt(iv, pt, aad)


def test_aes_gcm_nist_vectors():
    g = A.AesGcm(bytes(16))
    assert g.encrypt(bytes(12), b"", b"").hex() == "58e2fccefa7e3061367f1d57a4e7455a"
    key = bytes.fromhex("feffe9928665731c6d6a8f9467308308")
    iv = bytes.fromhex("cafebabefacedbaddecaf888")
    pt = bytes.fromhex(
        "d9313225f88406e5a55909c5aff5269a"
        "86a7a9531534f7da2e4c303d8a318a72"
        "1c3c0c95956809532fcf0e2449a6b525"
        "b16aedf5aa0de657ba637b391aafd255"
    )
    ct_tag = A.AesGcm(key).encrypt(iv, pt, b"")
    assert ct_tag.hex() == (
        "42831ec2217774244b7221b784d0d49c"
        "e3aa212f2c02a4e035c17e2329aca12e"
        "21d514b25466931c7d8f6a5aac84aa05"
        "1ba30b396a0aac973d58e091473f5985"
        "4d5c2af327cd64a62cf35abd2ba6fab4"
    )
    assert A.AesGcm(key).decrypt(iv, ct_tag, b"") == pt


def test_x25519_rfc7748_vector():
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    want = bytes.fromhex("c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552")
    assert X.x25519(k, u) == want == XJ.x25519(k, u)


def test_x25519_matches_jax_and_agrees():
    rng = np.random.default_rng(7)
    for _ in range(4):
        a = rng.integers(0, 256, 32, np.uint8).tobytes()
        b = rng.integers(0, 256, 32, np.uint8).tobytes()
        pa, pb = X.public_key(a), X.public_key(b)
        assert pa == XJ.public_key(a) and pb == XJ.public_key(b)
        shared = X.x25519(a, pb)
        assert shared == X.x25519(b, pa) == XJ.x25519(a, pb)
    # a low-order u (0) gives the all-zero output the TLS engines refuse
    assert X.x25519(a, bytes(32)) == bytes(32) == XJ.x25519(a, bytes(32))
