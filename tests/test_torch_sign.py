"""The port's batched Ed25519 signing against golden, the port's host
signer and the JAX sign.py, mirroring tests/test_bench_pool.py's
sign_batch check.  Signatures are compared byte for byte.  Every JAX call
here runs at one batch size (16), so the JAX base-mul compiles once."""

import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import sign as SJ
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
from firedancer_tpu_torch.ops.ed25519 import sign as ST

N = 16


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    secret = rng.integers(0, 256, 32, np.uint8).tobytes()
    msgs = [rng.integers(0, 256, int(n), np.uint8).tobytes()
            for n in rng.integers(1, 200, N)]
    return secret, msgs


def test_sign_batch_matches_golden_and_jax(batch):
    secret, msgs = batch
    sigs = ST.sign_batch(secret, msgs, device="cpu")
    pub = golden.public_from_secret(secret)
    for m, s in zip(msgs, sigs):
        assert s == golden.sign(secret, m)
        assert golden.verify(m, s, pub) == 0
    assert sigs == SJ.sign_batch(secret, msgs)


def test_sign_many_distinct_keys_matches_jax(batch):
    """Four keys, none given: the port derives their public keys as one
    device batch; the JAX run is handed them (one compile)."""
    _, msgs = batch
    rng = np.random.default_rng(2)
    secrets = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(4)]
    pairs = [(secrets[i % 4], m) for i, m in enumerate(msgs)]
    sigs = ST.sign_many(pairs, device="cpu")
    assert sigs == [hostpath.sign(s, m) for s, m in pairs]
    pubs = {s: hostpath.public_from_secret(s) for s in secrets}
    assert sigs == SJ.sign_many(pairs, pubs=pubs)
    assert ST.sign_many([], device="cpu") == []


def test_public_keys_match_golden():
    rng = np.random.default_rng(3)
    secrets = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(3)]
    assert ST.public_keys(secrets, device="cpu") == \
        [golden.public_from_secret(s) for s in secrets]


def test_base_mul_compress_matches_jax():
    rng = np.random.default_rng(4)
    rs = [0, 1, 2, golden.L - 1] + [int(v) % golden.L for v in
                                    rng.integers(0, 1 << 62, N - 4)]
    rs[-1] = golden.L // 3
    arr = np.stack([np.frombuffer(r.to_bytes(32, "little"), np.uint8) for r in rs])
    got = ST._base_mul_compress(torch.from_numpy(arr)).numpy()
    np.testing.assert_array_equal(got, np.asarray(SJ._base_mul_compress(arr)))
    for r, g in zip(rs[:4], got[:4]):
        assert g.tobytes() == golden.point_compress(golden.scalar_mul(r, golden.B))
