"""The port's CUDA kernel and slice on the card, held against the plain
versions on the CPU.  Every test here needs a CUDA card and skips without
one; the file imports neither jax nor the JAX package, so it runs on a host
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite).
Results are bools and integers: every comparison is exact."""

import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models import pipeline as PL
from firedancer_tpu_torch.ops.ed25519 import golden, hostpath
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
    assert kbuild.build_all() == ["verify_core"]
    assert kbuild.library_path("verify_core").exists()
    assert "registers" in kbuild.build_log("verify_core")


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
