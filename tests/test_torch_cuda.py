"""The port's CUDA kernels and slices on the card, held against the plain
versions on the CPU.  Every test here needs a CUDA card and skips without
one; the file imports neither jax nor the JAX package, so it runs on a host
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite).
Results are bools, integers and canonical field elements: every comparison
is exact."""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models import pipeline as PL
from firedancer_tpu_torch.ops.ed25519 import field as F
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
from firedancer_tpu_torch.ops.ed25519 import msm as MSM
from firedancer_tpu_torch.ops.ed25519 import verify as V
from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
from firedancer_tpu_torch.utils import kbuild

pytestmark = pytest.mark.cuda

N_BASE = 12


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form in the port")
    return torch.device("cuda")


def _noncanonical_y() -> int:
    return next(
        v for v in (golden.P + k for k in range(2, 19))
        if golden.point_decompress(v.to_bytes(32, "little"))
    )


def _corpus(n: int):
    """n lanes cycling over genuine and corrupted signatures: bad R, bad s,
    wrong key, bad message, identity key, non-canonical y of A and of R,
    negative-zero A; -> msgs, lens, sigs, pubs, golden verdicts."""
    rng = np.random.default_rng(11)
    sks = [rng.integers(0, 256, 32, np.uint8).tobytes() for _ in range(3)]
    w = 160
    msgs = rng.integers(0, 256, (N_BASE, w), np.uint8)
    lens = rng.integers(0, w + 1, N_BASE).astype(np.int32)
    msgs[np.arange(w)[None, :] >= lens[:, None]] = 0
    sigs = np.zeros((N_BASE, 64), np.uint8)
    pubs = np.zeros((N_BASE, 32), np.uint8)
    for i in range(N_BASE):
        sk = sks[i % 3]
        sigs[i] = np.frombuffer(
            hostpath.sign(sk, msgs[i, : lens[i]].tobytes()), np.uint8)
        pubs[i] = np.frombuffer(hostpath.public_from_secret(sk), np.uint8)
    y = _noncanonical_y().to_bytes(32, "little")
    sigs[1, 3] ^= 0xFF  # bad R
    sigs[2, 40] ^= 0x01  # bad s
    pubs[3] = rng.integers(0, 256, 32, np.uint8)  # wrong key
    msgs[4, 0] ^= 0x80  # bad message
    pubs[5] = 0
    pubs[5, 0] = 1  # identity key
    pubs[6] = np.frombuffer(y, np.uint8)  # non-canonical y of A
    sigs[7, :32] = np.frombuffer(y, np.uint8)  # non-canonical y of R
    pubs[8] = np.frombuffer((1 | (1 << 255)).to_bytes(32, "little"), np.uint8)
    idx = np.arange(n) % N_BASE
    msgs, lens, sigs, pubs = msgs[idx], lens[idx], sigs[idx], pubs[idx]
    want = np.array([
        golden.verify(msgs[i, : lens[i]].tobytes(), sigs[i].tobytes(),
                      pubs[i].tobytes()) == 0
        for i in range(N_BASE)
    ])[idx]
    return msgs, lens, sigs, pubs, want


def _core_inputs(n: int):
    msgs, lens, sigs, pubs, _ = _corpus(n)
    dig = np.stack([
        np.frombuffer(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes()
            + msgs[i, : lens[i]].tobytes()).digest(), np.uint8)
        for i in range(n)
    ])
    _, *core = V.prologue(*(torch.from_numpy(a) for a in (dig, sigs, pubs)))
    return core


def test_kernel_builds(dev):
    names = ["decompress_niels", "msm", "verify_core"]
    assert kbuild.build_all() == names
    for name in names:
        assert kbuild.library_path(name).exists()
        assert "registers" in kbuild.build_log(name)


@pytest.mark.parametrize("n", [13, 300])  # 300: a ragged last block
def test_kernel_matches_plain(dev, n):
    core = _core_inputs(n)
    want = VC.verify_core_plain(*core)
    launches = VC.LAUNCHES
    got = VC.verify_core(*(t.to(dev) for t in core))
    torch.cuda.synchronize()
    assert VC.LAUNCHES == launches + 1
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert torch.equal(got.cpu(), want)


def test_kernel_random_lanes(dev):
    """Random y limbs and digits (most y fail to decompress)."""
    rng = np.random.default_rng(41)
    n = 200
    k = rng.integers(-8, 8, (64, n)).astype(np.int32)
    s = rng.integers(-8, 8, (64, n)).astype(np.int32)
    ys = rng.integers(0, 1 << 13, (2, 20, n)).astype(np.int32)
    ys[:, 19] &= 0xFF
    signs = rng.integers(0, 2, (2, 1, n)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (k, s, ys[0], signs[0], ys[1], signs[1])]
    want = VC.verify_core_plain(*args)
    got = VC.verify_core(*(a.to(dev) for a in args))
    assert torch.equal(got.cpu(), want)


def test_kernel_wrapper_rejects_bad_inputs(dev):
    core = [t.to(dev) for t in _core_inputs(13)]
    launches = VC.LAUNCHES
    with pytest.raises(TypeError, match="int32"):
        VC.verify_core(core[0].long(), *core[1:])
    with pytest.raises(ValueError, match="contiguous"):
        VC.verify_core(core[0], core[1].T.contiguous().T, *core[2:])
    with pytest.raises(ValueError, match="shape"):
        VC.verify_core(core[0][:63], *core[1:])
    with pytest.raises(ValueError, match="expected"):
        VC.verify_core(*core[:5], core[5].cpu())
    assert VC.LAUNCHES == launches


def test_verify_entry_points_on_card(dev):
    msgs, lens, sigs, pubs, want = _corpus(40)
    got = V.verify_batch(msgs, lens, sigs, pubs)  # device=None: the card
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    dig = V.message_digests(
        torch.from_numpy(msgs), torch.from_numpy(lens).long(),
        torch.from_numpy(sigs), torch.from_numpy(pubs))
    pinned = V.verify_batch_digest_on(0)
    assert pinned.device == torch.device("cuda", 0)
    np.testing.assert_array_equal(
        pinned(dig.numpy(), sigs, pubs).cpu().numpy(), want)


def test_step_on_card_matches_cpu(dev):
    msgs, lens, sigs, pubs, _ = _corpus(24)
    tags2 = sigs[:, :8].copy().view(np.uint32).reshape(len(sigs), 2)
    outs = []
    for d in (dev, torch.device("cpu")):
        step = PL.make_step(d)
        bloom = PL.AgingBloom(d, capacity=1)
        res = []
        for _ in range(2):  # the second batch repeats the first
            keep, cur, met = step(msgs, lens, sigs, pubs, tags2, *bloom.buffers())
            bloom.update(cur, met)
            res.append((keep.cpu().numpy(), met.cpu().numpy()))
        cur, prev, ins, rot = bloom.to_numpy()
        outs.append((res, cur.copy(), prev.copy(), ins, rot))
    (res_g, cur_g, prev_g, ins_g, rot_g), (res_c, cur_c, prev_c, ins_c, rot_c) = outs
    for (kg, mg), (kc, mc) in zip(res_g, res_c):
        np.testing.assert_array_equal(kg, kc)
        np.testing.assert_array_equal(mg, mc)
    np.testing.assert_array_equal(cur_g, cur_c)
    np.testing.assert_array_equal(prev_g, prev_c)
    assert (ins_g, rot_g) == (ins_c, rot_c) and rot_g == 1
    assert res_g[0][0].any() and not res_g[1][0].any()


# ---------------------------------------------------------------------------
# the RLC path: decompress_niels, msm_buckets, verify_batch_digest_rlc
# ---------------------------------------------------------------------------


def _canon(t):
    """Every field element of a limb array whose limb axis is -2, canonical."""
    return F.canonical(t.movedim(-2, 0).reshape(20, -1).cpu())


def _niels_in(n: int):
    return _core_inputs(n)[2:]


@pytest.mark.parametrize("n", [13, 300])
def test_decompress_niels_kernel_matches_plain(dev, n):
    args = _niels_in(n)
    want = MSM.decompress_niels_plain(*args)
    launches = MSM.LAUNCHES["decompress_niels"]
    got = MSM.decompress_niels(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    assert MSM.LAUNCHES["decompress_niels"] == launches + 1
    assert got[2].dtype == torch.bool and torch.equal(got[2].cpu(), want[2])
    for g, w in zip(got[:2], want[:2]):
        assert g.device.type == "cuda" and tuple(g.shape) == (60, n)
        assert int(g.min()) >= 0 and int(g.max()) < 1 << 13
        assert torch.equal(_canon(g.reshape(3, 20, n)), _canon(w.reshape(3, 20, n)))


def test_decompress_niels_kernel_random_lanes(dev):
    rng = np.random.default_rng(43)
    n = 200
    ys = rng.integers(0, 1 << 13, (2, 20, n)).astype(np.int32)
    ys[:, 19] &= 0xFF
    signs = rng.integers(0, 2, (2, 1, n)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (ys[0], signs[0], ys[1], signs[1])]
    want = MSM.decompress_niels_plain(*args)
    got = MSM.decompress_niels(*(a.to(dev) for a in args))
    assert torch.equal(got[2].cpu(), want[2])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(_canon(g.reshape(3, 20, n)), _canon(w.reshape(3, 20, n)))


def _msm_in(n: int):
    """Digits of the corpus's k and s (as c and z) and masked niels."""
    k, s, a_y, a_sign, r_y, r_sign = _core_inputs(n)
    an3, rn3, ok = MSM.decompress_niels_plain(a_y, a_sign, r_y, r_sign)
    ident = torch.cat(MSM.PT.identity_niels_affine(n, "cpu"))
    okm = ok[None, :]
    cdig = torch.where(okm, k, 0)
    zdig = torch.where(okm, s[: MSM.ZWIN], 0)
    return [cdig, zdig, torch.where(okm, an3, ident), torch.where(okm, rn3, ident)]


@pytest.mark.parametrize("n,slots", [(13, 4), (13, 16), (300, 32), (300, 256)])
def test_msm_kernel_matches_plain(dev, n, slots):
    args = _msm_in(n)
    want = MSM.msm_buckets_plain(*args, slots)
    launches = MSM.LAUNCHES["msm_buckets"]
    got = MSM.msm_buckets(*(t.to(dev) for t in args), slots=slots)
    torch.cuda.synchronize()
    assert MSM.LAUNCHES["msm_buckets"] == launches + 1
    assert tuple(got.shape) == (MSM.NWIN, MSM.NBUCKET, 4, 20, slots)
    assert int(got.min()) >= 0 and int(got.max()) < 1 << 13
    assert torch.equal(_canon(got), _canon(want))


def test_rlc_kernel_wrappers_reject_bad_inputs(dev):
    nin = [t.to(dev) for t in _niels_in(13)]
    min_ = [t.to(dev) for t in _msm_in(13)]
    before = dict(MSM.LAUNCHES)
    with pytest.raises(TypeError, match="int32"):
        MSM.decompress_niels(nin[0].long(), *nin[1:])
    with pytest.raises(ValueError, match="contiguous"):
        MSM.decompress_niels(nin[0].T.contiguous().T, *nin[1:])
    with pytest.raises(ValueError, match="expected"):
        MSM.decompress_niels(*nin[:3], nin[3].cpu())
    with pytest.raises(ValueError, match="shape"):
        MSM.msm_buckets(min_[0], min_[1][:32], *min_[2:])
    with pytest.raises(ValueError, match="shape"):
        MSM.msm_buckets(min_[0][:, :12].contiguous(), *min_[1:])
    with pytest.raises(ValueError, match="power of two"):
        MSM.msm_buckets(*min_, slots=24)
    assert MSM.LAUNCHES == before


def test_rlc_on_card_matches_cpu(dev):
    msgs, lens, sigs, pubs, want = _corpus(40)
    dig = V.message_digests(
        torch.from_numpy(msgs), torch.from_numpy(lens).long(),
        torch.from_numpy(sigs), torch.from_numpy(pubs)).numpy()
    zb = np.random.default_rng(5).integers(0, 256, (40, 16), np.uint8)
    got = V.verify_batch_digest_rlc(dig, sigs, pubs, zb)  # device=None: the card
    assert got.device.type == "cuda"
    cpu = V.verify_batch_digest_rlc(dig, sigs, pubs, zb, device="cpu")
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())
    np.testing.assert_array_equal(cpu.numpy(), want)
    # the genuine lanes alone: accepted by the batch equation, through all
    # three kernels (verify_core once, for the subgroup gate)
    good = np.flatnonzero(want)
    before = dict(MSM.LAUNCHES, verify_core=VC.LAUNCHES)
    lane_ok, batch_ok = V._verify_digest_rlc_impl(*(
        torch.from_numpy(np.ascontiguousarray(a[good])).to(dev)
        for a in (dig, sigs, pubs, zb)))
    assert bool(batch_ok) and bool(lane_ok.all())
    after = dict(MSM.LAUNCHES, verify_core=VC.LAUNCHES)
    assert {k: after[k] - before[k] for k in after} == {
        "decompress_niels": 1, "msm_buckets": 1, "verify_core": 1}
