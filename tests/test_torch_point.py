"""The port's Ed25519 group code against the golden oracle and the JAX
package: decompression rules, the point formulas, the niels tables and the
double-scalar multiplication (exact: canonical integers and bools)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import point as PJ
from firedancer_tpu_torch.ops.ed25519 import field as FT
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
from firedancer_tpu_torch.ops.ed25519 import point as PT

P = golden.P


def _affine(pt):
    """Extended point (batch) -> list of affine (x, y) python ints."""
    x, y, z = (FT.limbs_to_int(c) for c in pt[:3])
    if not isinstance(x, list):
        x, y, z = [x], [y], [z]
    out = []
    for xi, yi, zi in zip(x, y, z):
        zinv = pow(zi % P, P - 2, P)
        out.append((xi * zinv % P, yi * zinv % P))
    return out


def _enc(vals):
    return np.stack([np.frombuffer(v, np.uint8) for v in vals])


def _encodings(rng):
    pubs = [hostpath.public_from_secret(rng.bytes(32)) for _ in range(5)]
    noncanon = next(
        int(P + k).to_bytes(32, "little")
        for k in range(2, 19)
        if golden.point_decompress(int(P + k).to_bytes(32, "little"))
    )
    neg_zero = (1 | (1 << 255)).to_bytes(32, "little")  # y = 1, x = 0, sign 1
    ident = (1).to_bytes(32, "little")
    rand = [rng.bytes(32) for _ in range(4)]
    return pubs + [noncanon, neg_zero, ident] + rand


def test_base_table_matches_jax():
    np.testing.assert_array_equal(PT.B_TABLE9, PJ.B_TABLE9)


def test_decompress_matches_golden_and_jax():
    rng = np.random.default_rng(31)
    encs = _encodings(rng)
    b = _enc(encs)
    pt, ok = PT.decompress(torch.from_numpy(b))
    want = [golden.point_decompress(e) for e in encs]
    assert ok.tolist() == [w is not None for w in want]
    assert ok.tolist()[5:8] == [True, False, True]  # noncanon, -0, identity
    for got, w in zip(_affine(pt), want):
        if w is not None:
            assert got == w
    pj, okj = PJ.decompress(jnp.asarray(b))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okj))
    for c_t, c_j in zip(pt, pj):
        np.testing.assert_array_equal(
            FT.canonical(c_t).numpy()[:, ok.numpy()],
            FT.canonical(torch.from_numpy(np.array(c_j))).numpy()[:, ok.numpy()],
        )


def _points(n, seed):
    rng = np.random.default_rng(seed)
    encs = [hostpath.public_from_secret(rng.bytes(32)) for _ in range(n)]
    pt, ok = PT.decompress(torch.from_numpy(_enc(encs)))
    assert ok.all()
    return pt, [golden.point_decompress(e) for e in encs]


def test_formulas_match_golden():
    p, gp = _points(4, 32)
    q, gq = _points(4, 33)
    assert _affine(PT.double(p)) == [golden.point_add(a, a) for a in gp]
    assert _affine(PT.add(p, q)) == [golden.point_add(a, b) for a, b in zip(gp, gq)]
    assert _affine(PT.add_niels(p, PT.to_niels(q))) == [
        golden.point_add(a, b) for a, b in zip(gp, gq)]
    digits = torch.tensor([3, -5, 8, 0], dtype=torch.int32)
    e = PT.lookup9_affine(FT.c("B_TABLE9", "cpu"), digits)
    want = [
        golden.point_add(a, golden.scalar_mul(int(d) % golden.L, golden.B))
        for a, d in zip(gp, digits.tolist())
    ]
    assert _affine(PT.add_niels_affine(p, e)) == want


def test_neg_table_and_lookup_match_jax():
    p, gp = _points(3, 34)
    tab = PT.build_neg_table9(p)
    tab_j = PJ.build_neg_table9(tuple(c.numpy() for c in p))
    canon = lambda t: FT.canonical(t.reshape(FT.NLIMB, -1))  # noqa: E731
    np.testing.assert_array_equal(
        canon(tab.permute(2, 0, 1, 3)).numpy(),
        canon(torch.from_numpy(np.array(tab_j)).permute(2, 0, 1, 3)).numpy(),
    )
    for d in (-8, -3, 0, 5, 7):
        digit = torch.full((3,), d, dtype=torch.int32)
        for got, want in zip(PT.lookup9(tab, digit),
                             PJ.lookup9(np.asarray(tab_j), digit.numpy())):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [35])
def test_double_scalar_mul_matches_golden(seed):
    from firedancer_tpu_torch.ops.ed25519 import scalar as ST

    p, gp = _points(3, seed)
    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % golden.L for _ in range(3)]
    ss = [0, 1, int.from_bytes(rng.bytes(32), "little") % golden.L]
    digits = lambda v: ST.to_signed_digits(  # noqa: E731
        torch.from_numpy(np.stack([FT.int_to_limbs(x) for x in v], axis=1)))
    acc = PT.double_scalar_mul(digits(ks), PT.build_neg_table9(p), digits(ss))
    want = [
        golden.point_add(
            golden.scalar_mul(k, golden.point_neg(a)),
            golden.scalar_mul(s, golden.B),
        )
        for k, s, a in zip(ks, ss, gp)
    ]
    assert _affine(acc) == want
