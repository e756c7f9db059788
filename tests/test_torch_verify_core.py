"""verify_core: the plain version against the JAX plain path (decompress +
double_scalar_mul + eq_external, as ops/ed25519/verify.py runs it off-TPU)
and the Pallas kernel, and the CUDA kernel's arithmetic (its source built
as plain C++) against the plain version.  The kernel itself is held against
the plain version on the card in tests/test_torch_cuda.py.

Lanes: the corrupted lanes of tests/test_pallas_kernel.py (bad R, bad s,
wrong key, bad message, identity key), non-canonical y encodings of A and of
R, a negative-zero A, and a lane built to ACCEPT with non-canonical y on
both A and R ([1](-A) + [0]B == -A == R).  B = 13 is not a multiple of the
TPU tile.  Every result is a bool: comparisons are exact."""

import ctypes
import hashlib
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
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
from firedancer_tpu_torch.ops.ed25519 import point as PT
from firedancer_tpu_torch.ops.ed25519 import scalar as ST
from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
from firedancer_tpu_torch.utils import kbuild

B = 13
ACCEPT_LANE = 8


def _noncanonical_y() -> int:
    return next(
        P for P in (golden.P + k for k in range(2, 19))
        if golden.point_decompress(P.to_bytes(32, "little"))
    )


def _corpus():
    rng = np.random.default_rng(3)
    sks = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(3)]
    msgs = rng.integers(0, 256, (B, 96), np.uint8)
    sigs = np.zeros((B, 64), np.uint8)
    pubs = np.zeros((B, 32), np.uint8)
    for i in range(B):
        sk = sks[i % 3]
        sigs[i] = np.frombuffer(hostpath.sign(sk, msgs[i].tobytes()), np.uint8)
        pubs[i] = np.frombuffer(hostpath.public_from_secret(sk), np.uint8)
    sigs[1, 3] ^= 0xFF  # bad R
    sigs[2, 40] ^= 0x01  # bad s
    pubs[3] = rng.integers(0, 256, 32, np.uint8)  # wrong key
    msgs[4, 0] ^= 0x80  # bad msg
    pubs[5] = 0
    pubs[5, 0] = 1  # identity point
    y = _noncanonical_y()
    pubs[6] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    sigs[7, :32] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    pubs[ACCEPT_LANE] = np.frombuffer(y.to_bytes(32, "little"), np.uint8)
    sigs[ACCEPT_LANE, :32] = np.frombuffer(
        (y | (1 << 255)).to_bytes(32, "little"), np.uint8)
    pubs[9] = np.frombuffer((1 | (1 << 255)).to_bytes(32, "little"), np.uint8)
    digests = np.stack([
        np.frombuffer(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes() + msgs[i].tobytes()
        ).digest(), np.uint8)
        for i in range(B)
    ])
    return digests, sigs, pubs


@pytest.fixture(scope="module")
def core_inputs():
    """(k, s, a_y, a_sign, r_y, r_sign) as numpy, from the port's prologue
    (asserted equal to the JAX prologue's), the accept lane's digits set to
    k = 1, s = 0."""
    digests, sigs, pubs = _corpus()
    k = ST.to_signed_digits(ST.reduce512(torch.from_numpy(digests)))
    s = ST.to_signed_digits(ST.from_bytes(torch.from_numpy(sigs[:, 32:].copy())))
    a_y, a_sign = PT.decompress_bytes(torch.from_numpy(pubs))
    r_y, r_sign = PT.decompress_bytes(torch.from_numpy(sigs[:, :32].copy()))
    port = [t.numpy().copy() for t in (k, s, a_y, a_sign, r_y, r_sign)]
    jax_in = [
        SJ.to_signed_digits(SJ.reduce512(jnp.asarray(digests))),
        SJ.to_signed_digits(SJ.from_bytes(jnp.asarray(sigs[:, 32:]))),
        *PJ.decompress_bytes(jnp.asarray(pubs)),
        *PJ.decompress_bytes(jnp.asarray(sigs[:, :32])),
    ]
    for got, want in zip(port, jax_in):
        np.testing.assert_array_equal(got, np.asarray(want))
    port[0][:, ACCEPT_LANE] = 0
    port[0][0, ACCEPT_LANE] = 1
    port[1][:, ACCEPT_LANE] = 0
    return port


@jax.jit
def _jax_plain_core(k, s, a_y, a_sign, r_y, r_sign):
    a_pt, a_ok = PJ.decompress_limbs(a_y, a_sign)
    r_pt, r_ok = PJ.decompress_limbs(r_y, r_sign)
    acc = PJ.double_scalar_mul(k, PJ.build_neg_table9(a_pt), s)
    return a_ok & r_ok & PJ.eq_external(acc, r_pt)


@pytest.fixture(scope="module")
def plain_out(core_inputs):
    return VC.verify_core_plain(*(torch.from_numpy(a) for a in core_inputs))


def test_plain_matches_jax_plain_path(core_inputs, plain_out):
    want = np.asarray(_jax_plain_core(*core_inputs))
    np.testing.assert_array_equal(plain_out.numpy(), want)
    # lanes 0, 10-12 are genuine; the accept lane holds by construction
    assert plain_out.tolist() == [
        True, False, False, False, False, False, False, False, True, False,
        True, True, True,
    ]


def test_wrapper_runs_plain_on_cpu(core_inputs, plain_out):
    launches = VC.LAUNCHES
    got = VC.verify_core(*(torch.from_numpy(a) for a in core_inputs))
    assert torch.equal(got, plain_out)
    assert VC.LAUNCHES == launches  # the plain version is not a launch


def test_kernel_consts_are_the_field_constants():
    c = VC.kernel_consts().astype(object)
    pos = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
    val = lambda i: sum(int(c[10 * i + j]) << pos[j] for j in range(10))  # noqa: E731
    assert [val(i) for i in range(3)] == [
        golden.D, 2 * golden.D % golden.P, golden.SQRT_M1]
    rows = PT.base_table9_ints()
    assert [val(3 + i) for i in range(27)] == [v for r in rows for v in r]


def test_muls_per_lane(core_inputs, monkeypatch):
    """The (squarings, multiplications) that the kernel's bound counts are
    those the plain version performs on one lane, and each costs the limb
    products its formula takes."""
    counts = {"sqr": 0, "mul": 0}
    sqr_rr, mul_rr = F.sqr_rr, F.mul_rr

    def counted(kind, fn):
        def run(*args):
            counts[kind] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(F, "sqr_rr", counted("sqr", sqr_rr))
    monkeypatch.setattr(F, "mul_rr", counted("mul", mul_rr))
    VC.verify_core_plain(*(torch.from_numpy(a[:, :1].copy()) for a in core_inputs))
    assert VC.field_ops_per_lane() == (counts["sqr"], counts["mul"])

    n = VC.LIMBS
    pairs = {(i, j) for i in range(n) for j in range(n)}
    unordered = {(min(i, j), max(i, j)) for i, j in pairs}
    assert (VC.PRODUCTS_PER_MUL, VC.PRODUCTS_PER_SQR) == (len(pairs), len(unordered))
    assert VC.products_per_lane() == (
        counts["sqr"] * len(unordered) + counts["mul"] * len(pairs))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/verify_core.cu compiled as plain C++: the kernel's own lane
    function, callable on the CPU."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's host form")
    out = tmp_path_factory.mktemp("vc") / "libverify_core_host.so"
    subprocess.run(
        [cxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror", "-shared",
         "-fPIC", "-x", "c++", str(kbuild.CSRC / "verify_core.cu"),
         "-o", str(out)],
        check=True, capture_output=True,
    )
    fn = ctypes.CDLL(str(out)).fdt_verify_core_host
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int]
    fn.restype = None

    def run(k, s, a_y, a_sign, r_y, r_sign):
        n = k.shape[1]
        arrs = [np.ascontiguousarray(a, np.int32) for a in
                (VC.kernel_consts(), k, s, a_y, a_sign, r_y, r_sign)]
        res = np.zeros(n, np.uint8)
        fn(*(a.ctypes.data for a in arrs), res.ctypes.data, n)
        return res.astype(bool)

    return run


def test_kernel_arithmetic_matches_plain(core_inputs, plain_out, host_kernel):
    np.testing.assert_array_equal(host_kernel(*core_inputs), plain_out.numpy())


def test_kernel_arithmetic_random_lanes(host_kernel):
    """Random y limbs and digits (most y fail to decompress): the kernel's
    lane function and the plain version agree lane for lane."""
    rng = np.random.default_rng(41)
    n = 24
    k = rng.integers(-8, 8, (64, n)).astype(np.int32)
    s = rng.integers(-8, 8, (64, n)).astype(np.int32)
    ys = rng.integers(0, 1 << 13, (2, 20, n)).astype(np.int32)
    ys[:, 19] &= 0xFF  # 255-bit values, as decompress_bytes makes
    signs = rng.integers(0, 2, (2, 1, n)).astype(np.int32)
    args = (k, s, ys[0], signs[0], ys[1], signs[1])
    want = VC.verify_core_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(host_kernel(*args), want.numpy())


@pytest.mark.slow
def test_plain_matches_pallas_interpret(core_inputs, plain_out):
    from firedancer_tpu.ops.ed25519 import pallas_kernel as PK

    got = PK.verify_core(*(jnp.asarray(a) for a in core_inputs), interpret=True)
    np.testing.assert_array_equal(plain_out.numpy(), np.asarray(got))

