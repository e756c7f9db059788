"""The port's CUDA kernels and slices on the card, held against the plain
versions on the CPU.  Every test here needs a CUDA card and skips without
one; the file imports neither jax nor the JAX package, so it runs on a host
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py sets up JAX for the rest of the suite).
Results are bools, integers and canonical field elements: every comparison
is exact."""

import functools
import hashlib

import numpy as np
import pytest
import torch

from firedancer_tpu_torch.models import pipeline as PL
from firedancer_tpu_torch.ops import blake3 as B3
from firedancer_tpu_torch.ops import keccak256 as KK
from firedancer_tpu_torch.ops import poh as POH
from firedancer_tpu_torch.ops import reedsol as RS
from firedancer_tpu_torch.ops import sha256 as SHA
from firedancer_tpu_torch.ops.ed25519 import sign as SIGN
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
    want = np.array([
        golden.verify(msgs[i, : lens[i]].tobytes(), sigs[i].tobytes(),
                      pubs[i].tobytes()) == 0
        for i in range(N_BASE)
    ])
    idx = np.arange(n) % N_BASE
    return msgs[idx], lens[idx], sigs[idx], pubs[idx], want[idx]


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
    names = ["decompress_niels", "msm", "sha256", "verify_core"]
    assert kbuild.build_all() == names
    for name in names:
        assert kbuild.library_path(name).exists()
        assert "registers" in kbuild.build_log(name)


# ragged teams and blocks (1, 13, 31, 33, 300) and the subgroup gate's width
RAGGED_B = [1, 13, 31, 33, 300, 8192]


@pytest.mark.parametrize("n", RAGGED_B)
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


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_dist_step_group_of_one_matches_single_card(dev):
    """The step as the one rank of an NCCL group (dp = mp = 1) equals the
    single-card step, and a batch run twice on the same buffers (a pool's
    resubmit) gives the same answer twice."""
    import torch.distributed as dist

    from firedancer_tpu_torch.parallel.mesh import init_mesh

    msgs, lens, sigs, pubs, _ = _corpus(24)
    tags2 = sigs[:, :8].copy().view(np.uint32).reshape(len(sigs), 2)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = init_mesh(1, 1)
        outs = []
        for m in (None, mesh):
            step = PL.make_step(dev, m)
            bloom = PL.AgingBloom(dev, capacity=1)
            res = []
            for _ in range(2):  # the second batch repeats the first
                bufs = bloom.buffers()
                first = step(msgs, lens, sigs, pubs, tags2, *bufs)
                again = step(msgs, lens, sigs, pubs, tags2, *bufs)
                for a, b in zip(first, again):
                    assert torch.equal(a, b)
                bloom.update(first[1], first[2])
                res.append((first[0].cpu().numpy(), first[2].cpu().numpy()))
            outs.append((res, bloom.to_numpy()))
    finally:
        dist.destroy_process_group()
    (res_1, st_1), (res_m, st_m) = outs
    for (k1, m1), (km, mm) in zip(res_1, res_m):
        np.testing.assert_array_equal(k1, km)
        np.testing.assert_array_equal(m1, mm)
    for a, b in zip(st_1, st_m):
        np.testing.assert_array_equal(a, b)
    assert res_1[0][0].any() and not res_1[1][0].any()


def test_run_steps_on_card_matches_cpu(dev):
    """parallel/dryrun.run_steps on one NCCL rank (the default, the card)
    gives the gloo CPU rank's keep, metrics and filter on the dedup half."""
    from firedancer_tpu_torch.parallel import dryrun

    rng = np.random.default_rng(3)
    tags2 = rng.integers(0, 2**32, (2, 16, 2), dtype=np.uint64).astype(np.uint32)
    tags2[1, :4] = tags2[0, :4]  # cross-batch repeats
    batches = [{"ok": rng.random(16) < 0.9, "tags2": t} for t in tags2]
    card = dryrun.run_steps(1, 1, batches, capacity=1, repeat=True)
    cpu = dryrun.run_steps(1, 1, batches, capacity=1, repeat=True, device="cpu")
    for got, want in zip(card[0], cpu[0]):
        for key in ("keep", "metrics", "cur"):
            for g, w in zip(got[key], want[key]):
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got["cur_after"], want["cur_after"])
        np.testing.assert_array_equal(got["prev_after"], want["prev_after"])
        assert (got["inserted"], got["rotations"]) == (want["inserted"], want["rotations"])


def _digest_batch(n):
    msgs, lens, sigs, pubs, want = _corpus(n)
    dig = np.stack([
        np.frombuffer(hashlib.sha512(
            sigs[i, :32].tobytes() + pubs[i].tobytes()
            + msgs[i, : lens[i]].tobytes()).digest(), np.uint8)
        for i in range(n)
    ])
    return (dig, sigs, pubs), want


def test_pool_on_card_matches_direct(dev):
    from firedancer_tpu_torch.parallel import dryrun
    from firedancer_tpu_torch.utils.devices import local_device_count

    batch, want = _digest_batch(40)
    fns = dryrun.domain_fns(local_device_count(), sample=batch)
    launches = VC.LAUNCHES
    rep = dryrun.run_verify_pool(local_device_count(), batches=[batch] * 6, fns=fns)
    assert VC.LAUNCHES == launches + 6
    for ok in rep["verdicts"]:
        np.testing.assert_array_equal(ok, want)
    assert rep["fallback_batches"] == 0 and rep["device_errors"] == 0


def _first_dispatch_fails():
    calls = []

    def hook(index):
        calls.append(index)
        if len(calls) == 1:
            raise RuntimeError("injected device error")

    return hook


def test_pool_fault_injected_card_domain_raises(dev):
    """A lone card domain quarantined by its first dispatch: the pool raises
    DomainsOut and lands nothing on the host."""
    from firedancer_tpu_torch.parallel import dryrun
    from firedancer_tpu_torch.tiles.verify import DomainsOut

    batch, _ = _digest_batch(16)
    with pytest.raises(DomainsOut) as e:
        dryrun.run_verify_pool(1, batches=[batch] * 3, fault_hook=_first_dispatch_fails(),
                               trip_after=1, backoff_base_s=300.0, backoff_max_s=300.0)
    c = e.value.counters
    assert (c["device_errors"], c["device_trips"], c["fallback_batches"]) == (1, 1, 0)
    assert sum(c["landed"]) == 0


def test_pool_transient_card_fault_lands_on_card(dev):
    """One failed dispatch below trip_after: the batch is resubmitted and
    lands on the card, with no quarantine and no host landing."""
    from firedancer_tpu_torch.parallel import dryrun

    batch, want = _digest_batch(16)
    rep = dryrun.run_verify_pool(1, batches=[batch] * 3, fault_hook=_first_dispatch_fails())
    for ok in rep["verdicts"]:
        np.testing.assert_array_equal(ok, want)
    assert (rep["device_errors"], rep["device_trips"], rep["fallback_batches"]) == (1, 0, 0)
    assert rep["resubmits"] == 1 and rep["landed"] == [3]


def test_dryrun_multichip_on_cards(dev, capfd):
    """entry.dryrun_multichip on the card: one NCCL rank per card for the
    step and the sustained run, then the pool on CUDA domains; more ranks
    than cards raise."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.utils.devices import local_device_count

    n = local_device_count()
    entry.dryrun_multichip(n)
    out = capfd.readouterr().out
    assert "dryrun_sustained ok: 6 steps" in out
    assert "dryrun_multichip ok: full pipeline on mesh" in out
    with pytest.raises(ValueError, match="NCCL ranks need"):
        entry.dryrun_multichip(n + 1)


# ---------------------------------------------------------------------------
# the RLC path: decompress_niels, msm_buckets, verify_batch_digest_rlc
# ---------------------------------------------------------------------------


def _canon(t):
    """Every field element of a limb array whose limb axis is -2, canonical."""
    return F.canonical(t.movedim(-2, 0).reshape(20, -1).cpu())


def _niels_in(n: int):
    return _core_inputs(n)[2:]


@pytest.mark.parametrize("n", RAGGED_B)
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


@functools.lru_cache(maxsize=None)
def _msm_in(n: int):
    """Digits of the corpus's k and s (as c and z) and masked niels."""
    k, s, a_y, a_sign, r_y, r_sign = _core_inputs(n)
    an3, rn3, ok = MSM.decompress_niels_plain(a_y, a_sign, r_y, r_sign)
    ident = torch.cat(MSM.PT.identity_niels_affine(n, "cpu"))
    okm = ok[None, :]
    cdig = torch.where(okm, k, 0)
    zdig = torch.where(okm, s[: MSM.ZWIN], 0)
    return [cdig, zdig, torch.where(okm, an3, ident), torch.where(okm, rn3, ident)]


# ragged and narrow batches, the deployment width at S = 256 and 128, and
# twice it
@pytest.mark.parametrize("n,slots", [(13, 4), (13, 16), (300, 32), (300, 256),
                                     (1, 1), (33, 32), (4096, 256), (4096, 128),
                                     (8192, 256)])
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


@pytest.mark.parametrize("n,slots", [(300, 32), (4096, 256)])
def test_msm_kernel_zero_digits_give_identity_buckets(dev, n, slots):
    """Every digit zero: every addition goes to the trash bucket, and every
    bucket written out is the identity (0, 1, 1, 0) in canonical limbs."""
    cdig, zdig, an3, rn3 = _msm_in(n)
    args = [torch.zeros_like(cdig), torch.zeros_like(zdig), an3, rn3]
    got = MSM.msm_buckets(*(t.to(dev) for t in args), slots=slots).cpu()
    coords = got.permute(2, 3, 0, 1, 4).reshape(4, 20, -1)  # (X, Y, Z, T)
    assert not coords[:, 1:].any()
    assert coords[:, 0].tolist() == [[v] * coords.shape[-1] for v in (0, 1, 1, 0)]
    assert torch.equal(_canon(got), _canon(MSM.msm_buckets_plain(*args, slots)))


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


# ---------------------------------------------------------------------------
# SHA-256, PoH and the plain-torch ops of the rest of ops/
# ---------------------------------------------------------------------------


def _sha_batch(n: int, width: int):
    rng = np.random.default_rng(n + width)
    lens = rng.integers(0, width + 1, n)
    lens[: min(n, 4)] = [0, min(55, width), min(56, width), width][: min(n, 4)]
    msgs = rng.integers(0, 256, (n, width), np.uint8)
    msgs[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msgs, lens


@pytest.mark.parametrize("n,width", [(1, 0), (13, 64), (300, 1232), (4096, 200)])
def test_sha256_blocks_kernel_matches_plain_and_hashlib(dev, n, width):
    msgs, lens = _sha_batch(n, width)
    words, nblocks = SHA.padded_words(torch.from_numpy(msgs), torch.from_numpy(lens))
    before = SHA.LAUNCHES["sha256_blocks"]
    got = SHA.sha256_blocks(words.to(dev), nblocks.to(dev))
    assert SHA.LAUNCHES["sha256_blocks"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  SHA.sha256_blocks_plain(words, nblocks).numpy())
    digests = SHA.sha256(msgs, lens).cpu().numpy()  # device=None: the card
    for i in range(0, n, max(1, n // 64)):
        assert digests[i].tobytes() == hashlib.sha256(msgs[i, : lens[i]].tobytes()).digest()


@pytest.mark.parametrize("n", [1, 33, 1024])
def test_poh_chain_kernel_matches_plain(dev, n):
    rng = np.random.default_rng(n)
    state = torch.from_numpy(rng.integers(0, 1 << 32, (n, 8), np.int64))
    mixin = torch.from_numpy(rng.integers(0, 1 << 32, (n, 8), np.int64))
    n_plain = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32))
    has = torch.from_numpy(rng.integers(0, 2, n).astype(bool))
    before = SHA.LAUNCHES["poh_chain"]
    got = SHA.poh_chain(*(t.to(dev) for t in (state, n_plain, mixin, has)))
    assert SHA.LAUNCHES["poh_chain"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), SHA.poh_chain_plain(state, n_plain, mixin, has).numpy())


def test_poh_entry_points_on_card(dev):
    rng = np.random.default_rng(3)
    st = rng.integers(0, 256, (5, 32), np.uint8)
    mx = rng.integers(0, 256, (5, 32), np.uint8)
    ref = st[0].tobytes()
    for _ in range(100):
        ref = hashlib.sha256(ref).digest()
    assert POH.append_n(st[:1], 100).cpu().numpy()[0].tobytes() == ref
    np.testing.assert_array_equal(POH.mixin(st, mx).cpu().numpy(),
                                  POH.mixin(st, mx, device="cpu").numpy())
    hc = np.array([0, 0, 1, 5, 9], np.int32)
    has = np.array([True, False, True, False, True])
    np.testing.assert_array_equal(
        POH.verify_entries(st, hc, mx, has, 9).cpu().numpy(),
        POH.verify_entries(st, hc, mx, has, 9, device="cpu").numpy())
    w = SHA.words_from_bytes(torch.from_numpy(st))
    np.testing.assert_array_equal(SHA.sha256_words32(w).cpu().numpy(),
                                  SHA.sha256_words32(w, device="cpu").numpy())


def test_sha_kernel_wrappers_reject_bad_inputs(dev):
    words = torch.zeros((2, 3, 15), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="shape"):
        SHA.sha256_blocks(words, torch.zeros(2, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shape"):
        SHA.poh_chain(torch.zeros((2, 8), dtype=torch.int64, device=dev),
                      torch.zeros(3, dtype=torch.int32, device=dev),
                      torch.zeros((2, 8), dtype=torch.int64, device=dev),
                      torch.zeros(2, dtype=torch.bool, device=dev))


def test_plain_ops_on_card_match_cpu(dev):
    """Reed-Solomon, Keccak-256, BLAKE3 and signing: the card's run of the
    plain-torch code equals the CPU's."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (67, 300), np.uint8)
    np.testing.assert_array_equal(RS.encode(data, 67).cpu().numpy(), RS._encode_host(data, 67))
    shreds = np.concatenate([data[:32], RS._encode_host(data[:32], 32)])
    present = np.ones(64, bool)
    present[:32] = False
    np.testing.assert_array_equal(RS.recover(shreds, present, 32).cpu().numpy(), data[:32])
    msgs, lens = _sha_batch(40, 1024)
    np.testing.assert_array_equal(KK.keccak256(msgs, lens).cpu().numpy(),
                                  KK.keccak256(msgs, lens, device="cpu").numpy())
    np.testing.assert_array_equal(B3.blake3(msgs, lens).cpu().numpy(),
                                  B3.blake3(msgs, lens, device="cpu").numpy())
    pairs = [(bytes([i]) * 32, b"msg %d" % i) for i in range(6)]
    assert SIGN.sign_many(pairs) == [hostpath.sign(s, m) for s, m in pairs]


def test_ingress_topology_on_card(dev):
    """The small ingress topology (synth -> verify on the card -> dedup ->
    sink, tests/test_pipeline.py's sizes): verdicts follow the pool's good
    mask, dedup drops exactly the repeats, survivors byte-match the pool, and
    every device batch launched verify_core once (after one warm-up)."""
    from firedancer_tpu_torch import entry

    VC.LAUNCHES = 0
    r = entry.ingress(max_lanes=32, idle_sleep_s=1e-3)
    c = r["counters"]
    good = r["pool"]["good"]
    n_good = int(good.sum())
    assert 0 < n_good < 24
    assert c["verify"]["in_frags"] == 48
    assert c["verify"]["verify_fail_txns"] == (24 - n_good) * 2
    assert c["verify"]["out_frags"] == n_good * 2
    assert c["dedup"]["dup_txns"] == n_good
    assert c["verify"]["fallback_batches"] == c["verify"]["device_errors"] == 0
    assert VC.LAUNCHES == c["verify"]["device_batches"] + 1
    np.testing.assert_array_equal(r["survivors"], r["pool"]["tags"][good])
    rows, szs = r["pool"]["rows"], r["pool"]["szs"]
    np.testing.assert_array_equal(r["payloads"], rows[good])
    np.testing.assert_array_equal(r["sizes"], szs[good])


def test_ingress_entry_counters_at_deployment_lanes(dev):
    """The pipeline entry at max_lanes 4096 and 1232-byte messages: 8,192
    frags over a 256-txn pool are exactly two full device batches, each one
    verify_core launch; the counters follow the pool's good mask."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.tiles.synth import make_txn_pool

    pool = make_txn_pool(256, corrupt_frac=0.1, seed=3)
    VC.LAUNCHES = 0
    r = entry.ingress(pool, total=8192, idle_sleep_s=1e-3)
    c = r["counters"]
    n_good = int(r["pool"]["good"].sum())
    assert c["verify"]["device_batches"] == 2 and VC.LAUNCHES == 3
    assert c["verify"]["verify_fail_txns"] == (256 - n_good) * 32
    assert c["dedup"]["dup_txns"] == n_good * 31
    assert c["sink"]["sunk_frags"] == n_good
    assert c["verify"]["fallback_batches"] == c["verify"]["device_errors"] == 0
    assert r["txns_per_s"] > 0 and len(r["landed_stamps"]) == 2
