"""The RLC path's modules against the JAX package, golden and Python ints:
mulmod/summod, scalar_mul_base, decompress_niels and the bucket MSM with
its finalization; and the two CUDA kernels' arithmetic (their sources built
as plain C++) against the plain versions.  The kernels themselves are held
against the plain versions on the card in tests/test_torch_cuda.py.

Every result is an integer, a canonical field element or a bool: every
comparison is exact.  Comparisons through Pallas interpret mode are marked
slow, as in tests/test_msm_rlc.py."""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firedancer_tpu.ops.ed25519 import point as PJ
from firedancer_tpu.ops.ed25519 import scalar as SJ
from firedancer_tpu_torch.ops.ed25519 import field as F
from firedancer_tpu_torch.ops.ed25519 import golden
from firedancer_tpu_torch.ops.ed25519 import msm as MSM
from firedancer_tpu_torch.ops.ed25519 import point as PT
from firedancer_tpu_torch.ops.ed25519 import scalar as ST
from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
from firedancer_tpu_torch.utils import kbuild

L = golden.L
P = golden.P
N = 6  # lanes of the MSM tests


def _limbs_of(x: int, rows: int = 20) -> np.ndarray:
    return np.array(
        [(x >> (13 * i)) & 0x1FFF for i in range(rows)], np.int32
    ).reshape(rows, 1)


def _cols(vals, rows=20):
    return torch.from_numpy(np.concatenate([_limbs_of(v, rows) for v in vals], axis=1))


def _affine(pt):
    """Extended point (batch) -> list of affine (x, y) python ints."""
    x, y, z = (F.limbs_to_int(c) for c in pt[:3])
    if not isinstance(x, list):
        x, y, z = [x], [y], [z]
    out = []
    for xi, yi, zi in zip(x, y, z):
        zinv = pow(zi % P, P - 2, P)
        out.append((xi * zinv % P, yi * zinv % P))
    return out


def _digits(vals, rows=20):
    return ST.to_signed_digits(_cols(vals, rows))


# ---------------------------------------------------------------------------
# scalar.mulmod / summod, point.scalar_mul_base
# ---------------------------------------------------------------------------


def test_mulmod_matches_python_and_jax():
    rng = np.random.default_rng(0)
    zs = [int.from_bytes(rng.bytes(16), "little") | 1 for _ in range(8)]
    ks = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(4)]
    # s up to 2^256: non-canonical lanes flow through the data path
    ks += [int.from_bytes(rng.bytes(32), "little") for _ in range(3)] + [(1 << 256) - 1]
    za, ka = _cols(zs, 10), _cols(ks)
    got = ST.mulmod(za, ka)
    assert F.limbs_to_int(got) == [z * k % L for z, k in zip(zs, ks)]
    np.testing.assert_array_equal(got.numpy(), np.asarray(SJ.mulmod(za.numpy(), ka.numpy())))


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_summod_matches_python_and_jax(n):
    rng = np.random.default_rng(n)
    vals = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    arr = _cols(vals)
    got = ST.summod(arr)
    assert tuple(got.shape) == (20, 1)
    assert F.limbs_to_int(got) == sum(vals) % L
    np.testing.assert_array_equal(got.numpy(), np.asarray(SJ.summod(arr.numpy())))


def test_scalar_mul_base_matches_golden_and_jax():
    rng = np.random.default_rng(3)
    vals = [0, 1, L - 1, int.from_bytes(rng.bytes(32), "little") % L]
    digits = _digits(vals)
    pt = PT.scalar_mul_base(digits)
    enc = PT.compress(pt).numpy()
    for i, s in enumerate(vals):
        assert enc[i].tobytes() == golden.point_compress(golden.scalar_mul(s, golden.B))
    pj = PJ.scalar_mul_base(digits.numpy())
    for c_t, c_j in zip(pt, pj):
        np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))  # limb for limb
    one = PT.identity(len(vals), "cpu")
    assert PT.eq_points(pt, pt).all()
    assert PT.eq_points(pt, one).tolist() == [True, False, False, False]


# ---------------------------------------------------------------------------
# decompress_niels
# ---------------------------------------------------------------------------


def _noncanonical_y() -> int:
    return next(
        v for v in (P + k for k in range(2, 19))
        if golden.point_decompress(v.to_bytes(32, "little"))
    )


def _encodings(seed, n):
    """n encodings: genuine public keys, then a non-canonical y, a negative
    zero, the identity and random bytes (most fail to decompress)."""
    rng = np.random.default_rng(seed)
    encs = [golden.public_from_secret(rng.bytes(32)) for _ in range(n - 6)]
    encs += [
        _noncanonical_y().to_bytes(32, "little"),
        (1 | (1 << 255)).to_bytes(32, "little"),
        (1).to_bytes(32, "little"),
    ]
    encs += [rng.bytes(32) for _ in range(3)]
    return np.stack([np.frombuffer(e, np.uint8) for e in encs])


@pytest.fixture(scope="module")
def niels_inputs():
    a = torch.from_numpy(_encodings(51, 13))
    r = torch.from_numpy(_encodings(52, 13)[::-1].copy())
    return (*PT.decompress_bytes(a), *PT.decompress_bytes(r))


@jax.jit
def _jax_niels(y, sign):
    pt, ok = PJ.decompress_limbs(y, sign)
    return jnp.concatenate(PJ.to_niels_affine(pt), axis=0), ok


def test_decompress_niels_plain_matches_jax_and_golden(niels_inputs):
    an3, rn3, ok = MSM.decompress_niels_plain(*niels_inputs)
    ins = [t.numpy() for t in niels_inputs]
    (ja, ja_ok), (jr, jr_ok) = _jax_niels(*ins[:2]), _jax_niels(*ins[2:])
    for got, w in zip((an3, rn3, ok), (ja, jr, ja_ok & jr_ok)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))  # limb for limb
    a_pts = [golden.point_decompress(e.tobytes()) for e in _encodings(51, 13)]
    r_pts = [golden.point_decompress(e.tobytes()) for e in _encodings(52, 13)[::-1]]
    assert ok.tolist() == [
        x is not None and y is not None for x, y in zip(a_pts, r_pts)
    ]
    for i, pt in enumerate(a_pts):
        if pt is not None:
            x, y = pt
            n = [F.limbs_to_int(an3[j * 20 : (j + 1) * 20, i : i + 1]) % P for j in range(3)]
            assert n == [(y + x) % P, (y - x) % P, 2 * golden.D * x * y % P]


def test_decompress_niels_wrapper_runs_plain_on_cpu(niels_inputs):
    before = dict(MSM.LAUNCHES)
    got = MSM.decompress_niels(*niels_inputs)
    for g, w in zip(got, MSM.decompress_niels_plain(*niels_inputs)):
        assert torch.equal(g, w)
    assert MSM.LAUNCHES == before  # the plain version is not a launch


def _count_field_ops(monkeypatch):
    counts = {"sqr": 0, "mul": 0}
    sqr_rr, mul_rr = F.sqr_rr, F.mul_rr

    def counted(kind, fn):
        def run(*args):
            counts[kind] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(F, "sqr_rr", counted("sqr", sqr_rr))
    monkeypatch.setattr(F, "mul_rr", counted("mul", mul_rr))
    return counts


def test_ops_per_lane(niels_inputs, monkeypatch):
    """The counts the kernels' bounds use are the field operations the
    plain versions perform: decompress_niels per lane, and one bucket
    addition (add_niels_affine with T) per nonzero digit."""
    counts = _count_field_ops(monkeypatch)
    MSM.decompress_niels_plain(*(t[:, :1].contiguous() for t in niels_inputs))
    assert MSM.DECOMPRESS_NIELS_OPS == (counts["sqr"], counts["mul"])
    assert MSM.decompress_niels_products_per_lane() == 510 * 55 + 42 * 100
    counts.update(sqr=0, mul=0)
    one = PT.identity(1, "cpu")
    PT.add_niels_affine(one, PT.identity_niels_affine(1, "cpu"), with_t=True)
    assert (counts["sqr"], counts["mul"]) == (0, MSM.ADD_MULS)
    cdig = torch.tensor([[0, 3], [-8, 0]] + [[0, 0]] * 62, dtype=torch.int32)
    zdig = torch.zeros((MSM.ZWIN + 2, 2), dtype=torch.int32)
    zdig[MSM.ZWIN - 1, 1] = 1
    zdig[MSM.ZWIN, 0] = 5  # beyond the z windows: not counted
    assert MSM.msm_products(cdig, zdig) == 3 * MSM.ADD_MULS * VC.PRODUCTS_PER_MUL


# ---------------------------------------------------------------------------
# the bucket MSM and its finalization
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def msm_case():
    """N lanes of known discrete logs: A_i = a_i B, R_i = r_i B, random c_i
    < L and odd z_i < 2^128; lane 2 is left out of the batch (zero digits,
    identity niels), as the RLC path masks a rejected lane."""
    rng = np.random.default_rng(61)
    a = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(N)]
    r = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(N)]
    c = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(N)]
    z = [int.from_bytes(rng.bytes(16), "little") | 1 for _ in range(N)]
    c[2] = z[2] = 0
    enc = lambda ks: torch.from_numpy(np.stack([  # noqa: E731
        np.frombuffer(golden.point_compress(golden.scalar_mul(k, golden.B)), np.uint8)
        for k in ks]))
    an3, rn3, ok = MSM.decompress_niels_plain(
        *PT.decompress_bytes(enc(a)), *PT.decompress_bytes(enc(r)))
    assert ok.all()
    ident = torch.cat(PT.identity_niels_affine(N, "cpu"))
    an3[:, 2], rn3[:, 2] = ident[:, 2], ident[:, 2]
    cdig = _digits(c)
    zdig = _digits(z)[: MSM.ZWIN].contiguous()
    u = sum(ci * ai + zi * ri for ci, ai, zi, ri in zip(c, a, z, r)) % L
    return dict(a=a, r=r, c=c, z=z, u=u, cdig=cdig, zdig=zdig, an3=an3, rn3=rn3)


@pytest.fixture(scope="module")
def plain_buckets(msm_case):
    m = msm_case
    return {s: MSM.msm_buckets_plain(m["cdig"], m["zdig"], m["an3"], m["rn3"], s)
            for s in (2, 8)}


def test_msm_sum_matches_golden(msm_case, plain_buckets):
    m = msm_case
    want = golden.scalar_mul(m["u"], golden.B)
    for s, bk in plain_buckets.items():
        assert tuple(bk.shape) == (MSM.NWIN, MSM.NBUCKET, 4, 20, s)
        assert _affine(MSM.msm_sum(bk)) == [want]


def test_window_sums_match_golden_at_every_slot_count(msm_case, plain_buckets):
    """W_w = sum_i d_w(c_i) A_i + d_w(z_i) R_i, whatever S."""
    m = msm_case

    def multiples(k):  # {d: [d] (k B)} for d in [-8, 8]
        p = golden.scalar_mul(k, golden.B)
        out = {0: golden.IDENT}
        for d in range(1, 9):
            out[d] = golden.point_add(out[d - 1], p)
            out[-d] = golden.point_neg(out[d])
        return out

    ma, mr = [multiples(k) for k in m["a"]], [multiples(k) for k in m["r"]]
    cd, zd = m["cdig"].numpy(), m["zdig"].numpy()
    want = []
    for w in range(MSM.NWIN):
        acc = golden.IDENT
        for i in range(N):
            acc = golden.point_add(acc, ma[i][int(cd[w, i])])
            if w < MSM.ZWIN:
                acc = golden.point_add(acc, mr[i][int(zd[w, i])])
        want.append(acc)
    for bk in plain_buckets.values():
        assert _affine(MSM.window_sums(bk)) == want


def test_msm_check_verdict(msm_case):
    m = msm_case
    args = (m["cdig"], m["zdig"], m["an3"], m["rn3"])
    assert bool(MSM.msm_check(*args, _digits([m["u"]])))
    assert not bool(MSM.msm_check(*args, _digits([(m["u"] + 1) % L]), slots=1))


def test_msm_wrapper_runs_plain_on_cpu(msm_case, plain_buckets):
    m = msm_case
    before = dict(MSM.LAUNCHES)
    got = MSM.msm_buckets(m["cdig"], m["zdig"], m["an3"], m["rn3"])
    assert MSM.slots_for(N) == 8
    assert torch.equal(got, plain_buckets[8])
    assert MSM.LAUNCHES == before
    with pytest.raises(ValueError, match="power of two"):
        MSM.msm_buckets(m["cdig"], m["zdig"], m["an3"], m["rn3"], slots=3)
    assert [MSM.slots_for(b) for b in (1, 13, 300, 4096)] == [1, 16, 256, 256]


# ---------------------------------------------------------------------------
# the kernels' arithmetic, built as plain C++
# ---------------------------------------------------------------------------


def _host_lib(tmp_path_factory, name):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's host form")
    out = tmp_path_factory.mktemp(name) / f"lib{name}_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-x", "c++", str(kbuild.CSRC / f"{name}.cu"), "-o", str(out)],
        check=True, capture_output=True,
    )
    return ctypes.CDLL(str(out))


def _i32(t):
    return np.ascontiguousarray(t.numpy() if isinstance(t, torch.Tensor) else t, np.int32)


@pytest.fixture(scope="module")
def host_decompress_niels(tmp_path_factory):
    fn = _host_lib(tmp_path_factory, "decompress_niels").fdt_decompress_niels_host
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    fn.restype = None

    def run(a_y, a_sign, r_y, r_sign):
        n = a_y.shape[1]
        ins = [_i32(x) for x in (VC.kernel_consts(), a_y, a_sign, r_y, r_sign)]
        an3, rn3 = np.zeros((60, n), np.int32), np.zeros((60, n), np.int32)
        ok = np.zeros(n, np.uint8)
        fn(*(x.ctypes.data for x in ins), an3.ctypes.data, rn3.ctypes.data,
           ok.ctypes.data, n)
        return torch.from_numpy(an3), torch.from_numpy(rn3), torch.from_numpy(ok.astype(bool))

    return run


@pytest.fixture(scope="module")
def host_msm(tmp_path_factory):
    fn = _host_lib(tmp_path_factory, "msm").fdt_msm_buckets_host
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
    fn.restype = None

    def run(cdig, zdig, an3, rn3, slots):
        n = cdig.shape[1]
        ins = [_i32(x) for x in (cdig, zdig, an3, rn3)]
        out = np.zeros((MSM.NWIN, MSM.NBUCKET, 4, 20, slots), np.int32)
        fn(*(x.ctypes.data for x in ins), out.ctypes.data, n, slots)
        return torch.from_numpy(out)

    return run


def _canon(t):
    """Every field element of a (..., 20, S)-shaped limb array, canonical."""
    x = t.movedim(-2, 0).reshape(20, -1)
    return F.canonical(x)


def test_decompress_niels_kernel_arithmetic(niels_inputs, host_decompress_niels):
    an3, rn3, ok = host_decompress_niels(*niels_inputs)
    pan3, prn3, pok = MSM.decompress_niels_plain(*niels_inputs)
    assert torch.equal(ok, pok)
    for got, want in zip((an3, rn3), (pan3, prn3)):
        assert int(got.min()) >= 0 and int(got.max()) < 1 << 13  # canonical limbs
        g = got.reshape(3, 20, -1).movedim(1, 0).reshape(20, -1)
        w = want.reshape(3, 20, -1).movedim(1, 0).reshape(20, -1)
        assert torch.equal(g, F.canonical(w))  # every lane, failed ones too


def test_decompress_niels_kernel_random_lanes(host_decompress_niels):
    rng = np.random.default_rng(41)
    n = 24
    ys = rng.integers(0, 1 << 13, (2, 20, n)).astype(np.int32)
    ys[:, 19] &= 0xFF  # 255-bit values, as decompress_bytes makes
    signs = rng.integers(0, 2, (2, 1, n)).astype(np.int32)
    args = [torch.from_numpy(x) for x in (ys[0], signs[0], ys[1], signs[1])]
    got = host_decompress_niels(*args)
    want = MSM.decompress_niels_plain(*args)
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_canon(g.reshape(3, 20, n)), _canon(w.reshape(3, 20, n)))


@pytest.mark.parametrize("slots", [2, 8])
def test_msm_kernel_arithmetic(msm_case, plain_buckets, host_msm, slots):
    """The kernel's additions equal the plain version's after
    canonicalisation, with canonical (kernel) and carried (plain) niels in."""
    m = msm_case
    want = _canon(plain_buckets[slots])
    got = host_msm(m["cdig"], m["zdig"], m["an3"], m["rn3"], slots)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 13
    assert torch.equal(_canon(got), want)
    canon_n = [_canon(x.reshape(3, 20, N)).reshape(20, 3, N).movedim(0, 1).reshape(60, N)
               for x in (m["an3"], m["rn3"])]
    got2 = host_msm(m["cdig"], m["zdig"], *canon_n, slots)
    assert torch.equal(_canon(got2), want)


def test_msm_kernel_random_digits(host_msm):
    """Digits over all of [-8, 8] with repeats of one point (bucket
    doublings), on 13 lanes (a ragged last step at S = 4)."""
    rng = np.random.default_rng(71)
    n, slots = 13, 4
    keys = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(4)]
    enc = torch.from_numpy(np.stack([
        np.frombuffer(golden.point_compress(golden.scalar_mul(keys[i % 4], golden.B)), np.uint8)
        for i in range(n)]))
    an3, rn3, ok = MSM.decompress_niels_plain(*PT.decompress_bytes(enc), *PT.decompress_bytes(enc))
    assert ok.all()
    cdig = torch.from_numpy(rng.integers(-8, 9, (64, n)).astype(np.int32))
    zdig = torch.from_numpy(rng.integers(-8, 9, (MSM.ZWIN, n)).astype(np.int32))
    want = MSM.msm_buckets_plain(cdig, zdig, an3, rn3, slots)
    assert torch.equal(_canon(host_msm(cdig, zdig, an3, rn3, slots)), _canon(want))


# ---------------------------------------------------------------------------
# Pallas interpret mode (slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_decompress_niels_matches_pallas_interpret(niels_inputs):
    from firedancer_tpu.ops.ed25519 import msm_kernel as MK

    got = MSM.decompress_niels_plain(*niels_inputs)
    want = MK.decompress_niels(*(t.numpy() for t in niels_inputs), interpret=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_canon(g.reshape(3, 20, -1)),
                           _canon(torch.from_numpy(np.array(w)).reshape(3, 20, -1)))


@pytest.mark.slow
def test_msm_check_matches_pallas_interpret(msm_case):
    from firedancer_tpu.ops.ed25519 import msm_kernel as MK

    m = msm_case
    for u in (m["u"], (m["u"] + 1) % L):
        udig = _digits([u])
        port = bool(MSM.msm_check(m["cdig"], m["zdig"], m["an3"], m["rn3"], udig))
        jx = MK.msm_check(m["cdig"].numpy(), m["zdig"].numpy(), m["an3"].numpy(),
                          m["rn3"].numpy(), udig.numpy(), interpret=True)
        assert port == bool(np.asarray(jx)) == (u == m["u"])
