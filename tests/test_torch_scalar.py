"""The port's mod-L scalar code against the JAX package and Python ints
(exact: the results are integers)."""

import numpy as np
import torch

from firedancer_tpu.ops.ed25519 import scalar as SJ
from firedancer_tpu_torch.ops.ed25519 import field as FT
from firedancer_tpu_torch.ops.ed25519 import scalar as ST
from firedancer_tpu_torch.ops.ed25519.golden import L

B = 13


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _le(vals, n):
    return np.stack([np.frombuffer(v.to_bytes(n, "little"), np.uint8) for v in vals])


def test_from_bytes_and_is_canonical():
    rng = np.random.default_rng(11)
    vals = [0, 1, L - 1, L, L + 1, (1 << 253) - 1, (1 << 256) - 1]
    vals += [int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(B - len(vals))]
    b = _le(vals, 32)
    s = ST.from_bytes(torch.from_numpy(b))
    _same(s, SJ.from_bytes(b))
    got = ST.is_canonical(s)
    _same(got, SJ.is_canonical(s.numpy()))
    assert got.tolist() == [v < L for v in vals]


def test_reduce512():
    rng = np.random.default_rng(12)
    vals = [0, L, 2 * L - 1, (1 << 512) - 1, L * (1 << 259)]
    vals += [int.from_bytes(rng.bytes(64), "little") for _ in range(B - len(vals))]
    d = _le(vals, 64)
    got = ST.reduce512(torch.from_numpy(d))
    _same(got, SJ.reduce512(d))
    assert FT.limbs_to_int(got) == [v % L for v in vals]


def test_to_signed_digits():
    rng = np.random.default_rng(13)
    vals = [0, 1, L - 1, 8, 0x8888, (1 << 253) - 1]
    vals += [int.from_bytes(rng.bytes(32), "little") % L for _ in range(B - len(vals))]
    s = torch.from_numpy(np.stack([FT.int_to_limbs(v) for v in vals], axis=1))
    dig = ST.to_signed_digits(s)
    _same(dig, SJ.to_signed_digits(s.numpy()))
    assert int(dig.min()) >= -8 and int(dig.max()) <= 7
    d = dig.numpy().astype(object)
    assert [sum(int(d[i, j]) << (4 * i) for i in range(64)) for j in range(B)] == vals
