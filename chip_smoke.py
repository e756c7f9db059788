#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (firedancer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's device ingress step (SHA-512 -> Ed25519 verify with the
hand-written verify_core kernel -> aging-bloom dedup -> pack prefilter) and
its batch (RLC) verify path (verify_batch_digest_rlc: the decompress_niels
and msm_buckets kernels, the plain finalization, the verify_core subgroup
gate) at deployment size: B = 4096 lanes per batch, 1232-byte messages, the
full 2 x 2^28-bit filter pair resident on the card, K = 1024 pack
candidates of 1024 account bits.  Phases, one JSON line each:

  device       card name, power limit, TF32 switches (both set off)
  build        every kernel built from csrc/ by utils/kbuild.py, in parallel
  kernel       verify_core against verify_core_plain on all 4096 lanes
  slice        several consecutive steps and the pack prefilter, checked
               against a host model of the dedup rules, the golden oracle on
               sampled lanes and the host greedy pack oracle; the kernel's
               launch counter must move
  rlc_kernels  decompress_niels and msm_buckets against their plain versions
               on all 4096 lanes of the first batch; the batch verdict from
               the kernel's buckets equals the one from the plain buckets
  rlc          verify_batch_digest_rlc on an honest batch (accepted by the
               batch equation), the first corpus batch and a batch with the
               order-2 torsion-cancellation pair planted (rejected by the
               equation and by the subgroup gate, and decided by the
               per-signature path); verdicts against
               the per-signature path, the corpus and the golden oracle;
               every kernel of the path must launch
  times        CUDA-event medians per layer, verifies/s, each kernel's bound

then a `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises: the script exits
non-zero and prints no result.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

B = 4096  # verify_max_lanes (app/config.py)
W = 1232  # Solana's maximum transaction size
N_BATCHES = 4
N_SIGNERS = 64
K_PACK, W_PACK = 1024, 16  # scan_limit; 16 u64 words = 1024 account bits
TXN_LIMIT, CU_LIMIT = 31, 1_500_000
#: where the torsion-cancellation pair is planted in the honest batch
TORSION_LANES = (1, B // 2)
KINDS = ("bad_r", "bad_s", "wrong_key", "bad_msg", "identity_key", "noncanon_y")
# H100 SXM published rates (NVIDIA's data sheet, 700 W): 3.35 TB/s HBM and
# 67 TFLOP/s FP32 = 33.5e12 FMA/s; a 32-bit integer multiply-add issues at
# half the FP32 FMA rate on compute capability 9.0 (the throughput table
# of NVIDIA's CUDA C++ Programming Guide)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2


def layout():
    """Lane layout of a batch: -> (first corrupted lane, lanes per
    corrupted kind, within-batch duplicates, first lane repeated from the
    previous batch, repeated lanes)."""
    per_kind = max(1, B // 512)
    return (3 * B) // 4, per_kind, max(1, B // 128), B // 4, B // 8


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# corpus (host side, seeded)
# ---------------------------------------------------------------------------


def _sign_chunk(job):
    """Worker: sign (signer index, message bytes) pairs -> signature bytes."""
    sys.path.insert(0, ROOT)
    from firedancer_tpu_torch.ops.ed25519 import hostpath

    secrets, items = job
    return [hostpath.sign(secrets[k], m) for k, m in items]


def build_corpus(seed: int):
    """N_BATCHES batches of B lanes: unique txns, within-batch duplicates,
    cross-batch repeats and corrupted lanes; -> list of dicts with msgs,
    lens, sigs, pubs, tags2 and the lanes' expected verdicts."""
    from firedancer_tpu_torch.ops.ed25519 import golden, hostpath

    rng = np.random.default_rng(seed)
    secrets = [rng.bytes(32) for _ in range(N_SIGNERS)]
    pubkeys = [hostpath.public_from_secret(s) for s in secrets]
    n = N_BATCHES * B
    msgs = rng.integers(0, 256, (n, W), np.uint8)
    lens = rng.integers(200, W + 1, n).astype(np.int32)
    msgs[np.arange(W)[None, :] >= lens[:, None]] = 0
    signer = rng.integers(0, N_SIGNERS, n)
    items = [(int(signer[i]), msgs[i, : lens[i]].tobytes()) for i in range(n)]
    procs = min(8, os.cpu_count() or 1)
    chunks = [items[i::procs] for i in range(procs)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(procs) as pool:
        parts = pool.map(_sign_chunk, [(secrets, c) for c in chunks])
    sigs = np.zeros((n, 64), np.uint8)
    for i, part in enumerate(parts):
        sigs[i::procs] = np.frombuffer(b"".join(part), np.uint8).reshape(-1, 64)
    pubs = np.stack([np.frombuffer(pubkeys[k], np.uint8) for k in signer])

    corrupt0, per_kind, n_dup, rep_from, n_rep = layout()
    noncanon = next(
        v for v in (golden.P + k for k in range(2, 19))
        if golden.point_decompress(v.to_bytes(32, "little"))
    ).to_bytes(32, "little")
    batches = []
    for b in range(N_BATCHES):
        sl = slice(b * B, (b + 1) * B)
        bt = {"msgs": msgs[sl].copy(), "lens": lens[sl].copy(),
              "sigs": sigs[sl].copy(), "pubs": pubs[sl].copy()}
        bt["ok"] = np.ones(B, bool)
        bt["kind"] = ["valid"] * B
        for j, kind in enumerate(KINDS):
            for r in range(per_kind):
                i = corrupt0 + per_kind * j + r
                bt["ok"][i] = False
                bt["kind"][i] = kind
                if kind == "bad_r":
                    bt["sigs"][i, 3] ^= 0xFF
                elif kind == "bad_s":
                    bt["sigs"][i, 40] ^= 0x01
                elif kind == "wrong_key":
                    bt["pubs"][i] = rng.integers(0, 256, 32, np.uint8)
                elif kind == "bad_msg":
                    bt["msgs"][i, 0] ^= 0x80
                elif kind == "identity_key":
                    bt["pubs"][i] = 0
                    bt["pubs"][i, 0] = 1
                else:
                    bt["pubs"][i] = np.frombuffer(noncanon, np.uint8)
        # cross-batch repeats: lanes 0.. repeat lanes rep_from.. of the
        # previous batch; then within-batch duplicates: the last n_dup
        # lanes repeat lanes 0..n_dup-1
        if batches:
            _copy(batches[-1], bt, range(rep_from, rep_from + n_rep),
                  range(n_rep))
        _copy(bt, bt, range(n_dup), range(B - n_dup, B))
        bt["tags2"] = bt["sigs"][:, :8].copy().view(np.uint32).reshape(B, 2)
        batches.append(bt)
    return batches


def _copy(src, dst, from_lanes, to_lanes):
    f, t = list(from_lanes), list(to_lanes)
    for key in ("msgs", "lens", "sigs", "pubs", "ok"):
        dst[key][t] = src[key][f]
    for a, b in zip(f, t):
        dst["kind"][b] = src["kind"][a]


def digests_of(bt):
    return np.stack([
        np.frombuffer(hashlib.sha512(
            bt["sigs"][i, :32].tobytes() + bt["pubs"][i].tobytes()
            + bt["msgs"][i, : bt["lens"][i]].tobytes()).digest(), np.uint8)
        for i in range(len(bt["lens"]))
    ])


class DedupModel:
    """Exact host model of the step's dedup rules over python sets (the
    device filter is a bloom; at these counts a false positive has
    probability below 1e-15)."""

    def __init__(self, capacity):
        self.cur, self.prev = set(), set()
        self.inserted, self.rotations, self.capacity = 0, 0, capacity

    def step(self, tags2, ok):
        tags = [(int(h) << 32) | int(l) for l, h in tags2]
        seen, keep, m = set(), [], [0, 0, 0, 0]
        new = []
        for t, good in zip(tags, ok):
            first = t not in seen
            seen.add(t)
            hit = t in self.cur or t in self.prev
            keep.append(bool(good and not hit and first))
            m[0] += int(good)
            m[1] += int(not good)
            m[2] += int(good and hit)
            if good and first:
                new.append(t)
                m[3] += int(not hit)
        self.cur.update(new)
        self.inserted += m[3]
        if self.inserted >= self.capacity:
            self.prev, self.cur = self.cur, set()
            self.inserted = 0
            self.rotations += 1
        return np.array(keep), m


def check_golden(golden, bt, verdicts) -> int:
    """Hold `verdicts` of batch `bt` against the golden oracle on sampled
    lanes: one of each corrupted kind, valid lanes, a cross-batch repeat and
    a within-batch duplicate; -> the number of lanes checked."""
    corrupt0, per_kind, *_ = layout()
    sample = [corrupt0 + per_kind * j for j in range(len(KINDS))]
    sample += [0, 5, B // 3, B // 2, (2 * B) // 3, B - 1]
    for i in sample:
        g = golden.verify(bt["msgs"][i, : bt["lens"][i]].tobytes(),
                          bt["sigs"][i].tobytes(), bt["pubs"][i].tobytes())
        if (g == 0) != bool(bt["ok"][i]) or (g == 0) != bool(verdicts[i]):
            raise AssertionError(f"lane {i} ({bt['kind'][i]}) vs golden {g}")
    return len(sample)


def honest_batch(batches):
    """B lanes of the corpus that verify (every batch's valid lanes, in
    order), as a batch dict."""
    keys = ("msgs", "lens", "sigs", "pubs")
    hb = {k: np.concatenate([bt[k][bt["ok"]] for bt in batches])[:B] for k in keys}
    if len(hb["lens"]) != B:
        raise AssertionError("the corpus has fewer than B valid lanes")
    hb["ok"] = np.ones(B, bool)
    hb["kind"] = ["valid"] * B
    return hb


def torsion2_pair(golden):
    """Two signatures with mixed-order R' = R + T2, T2 = (0, -1) of order 2,
    whose cofactorless residuals are both T2: each fails strict
    verification, but z1 T2 + z2 T2 = identity for every odd z pair, so the
    batch equation alone would accept both.  Built from a known secret:
    R = rB, k hashed over the R' encoding, s = r + k a.  -> (msgs, sigs,
    pubs) as lists of bytes."""
    t2 = (0, golden.P - 1)
    sk = b"\x07" * 32
    a, prefix = golden.secret_expand(sk)
    a_enc = golden.public_from_secret(sk)
    msgs, sigs = [], []
    for ctr in range(2):
        m = b"torsion-cancel-%d" % ctr
        r = golden._sha512_int(prefix, m) % golden.L
        rs = golden.point_compress(
            golden.point_add(golden.scalar_mul(r, golden.B), t2))
        k = golden._sha512_int(rs, a_enc, m) % golden.L
        msgs.append(m)
        sigs.append(rs + ((r + k * a) % golden.L).to_bytes(32, "little"))
    return msgs, sigs, [a_enc, a_enc]


def torsion_batch(golden, hb):
    """The honest batch with the torsion pair planted at TORSION_LANES."""
    tb = {k: v.copy() for k, v in hb.items() if k != "kind"}
    tb["kind"] = list(hb["kind"])
    for lane, m, sig, pub in zip(TORSION_LANES, *torsion2_pair(golden)):
        tb["msgs"][lane] = 0
        tb["msgs"][lane, : len(m)] = np.frombuffer(m, np.uint8)
        tb["lens"][lane] = len(m)
        tb["sigs"][lane] = np.frombuffer(sig, np.uint8)
        tb["pubs"][lane] = np.frombuffer(pub, np.uint8)
        tb["ok"][lane] = False
        tb["kind"][lane] = "torsion2"
    return tb


def check_golden_lanes(golden, bt, verdicts, lanes) -> int:
    for i in lanes:
        g = golden.verify(bt["msgs"][i, : bt["lens"][i]].tobytes(),
                          bt["sigs"][i].tobytes(), bt["pubs"][i].tobytes())
        if (g == 0) != bool(bt["ok"][i]) or (g == 0) != bool(verdicts[i]):
            raise AssertionError(f"lane {i} ({bt['kind'][i]}) vs golden {g}")
    return len(lanes)


def bound(products: int, nbytes: int) -> dict:
    """The least time of a kernel's work: the larger of its 32x32->64
    products at the card's integer multiply-add rate and its bytes at the
    card's memory rate."""
    ops_ms = products / INT32_MAD_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"int32_multiply_adds": products, "ops_ms": ops_ms,
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def pack_candidates(seed: int):
    rng = np.random.default_rng(seed)
    rw = np.zeros((K_PACK, W_PACK), np.uint64)
    wr = np.zeros((K_PACK, W_PACK), np.uint64)
    one = np.uint64(1)
    for i in range(K_PACK):
        for b in rng.integers(0, W_PACK * 64, 6):
            rw[i, b >> 6] |= one << np.uint64(b & 63)
        for b in rng.integers(0, W_PACK * 64, 2):
            wr[i, b >> 6] |= one << np.uint64(b & 63)
    rw |= wr
    in_rw = np.zeros(W_PACK, np.uint64)
    for b in rng.integers(0, W_PACK * 64, 16):
        in_rw[b >> 6] |= one << np.uint64(b & 63)
    costs = rng.integers(1_000, 200_000, K_PACK).astype(np.int64)
    return rw, wr, in_rw, np.zeros(W_PACK, np.uint64), costs


def host_greedy(rw, wr, in_rw, in_w, costs, cu_limit, txn_limit):
    sel_rw, sel_w = in_rw.copy(), in_w.copy()
    cu, taken = 0, 0
    want = np.zeros(len(costs), bool)
    for i in range(len(costs)):
        c = int(costs[i])
        if cu + c > cu_limit or taken >= txn_limit:
            continue
        if (wr[i] & sel_rw).any() or (rw[i] & sel_w).any():
            continue
        want[i] = True
        sel_rw |= rw[i]
        sel_w |= wr[i]
        cu += c
        taken += 1
    return want


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def sync() -> None:
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median CUDA-event time of fn() in ms, after warm-up calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def run(dev) -> dict:
    """Every phase on `dev`; -> the final result object.  Raises on any
    failure."""
    import torch

    from firedancer_tpu_torch.models import pipeline as PL
    from firedancer_tpu_torch.ops import pack_select
    from firedancer_tpu_torch.ops.ed25519 import field as F
    from firedancer_tpu_torch.ops.ed25519 import golden
    from firedancer_tpu_torch.ops.ed25519 import msm as MSM
    from firedancer_tpu_torch.ops.ed25519 import verify as V
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.utils import kbuild

    t_start = time.time()
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    # -- 1. device ----------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    # -- 2. build -----------------------------------------------------------
    t0 = time.time()
    names = kbuild.build_all()
    build_s = time.time() - t0
    ptxas = {
        n: [ln.strip() for ln in kbuild.build_log(n).splitlines()
            if "registers" in ln or "stack frame" in ln]
        for n in names
    }
    emit({"phase": "build", "kernels": names, "seconds": build_s,
          "ptxas": ptxas})

    # -- corpus -------------------------------------------------------------
    t0 = time.time()
    batches = build_corpus(seed=2026)
    emit({"phase": "corpus", "batches": N_BATCHES, "lanes": B, "width": W,
          "seconds": time.time() - t0})

    # -- 3. kernel against plain --------------------------------------------
    b0 = batches[0]
    ok0, *core_in = V.prologue(put(digests_of(b0)), put(b0["sigs"]),
                               put(b0["pubs"]))
    ker = VC.verify_core(*core_in)
    plain = VC.verify_core_plain(*core_in)
    sync()
    agree = bool(torch.equal(ker, plain))
    max_abs_err = int((ker.int() - plain.int()).abs().max())
    if not agree:
        raise AssertionError("verify_core disagrees with verify_core_plain")
    verdicts0 = (ok0 & ker).cpu().numpy()
    if not np.array_equal(verdicts0, b0["ok"]):
        raise AssertionError("verdicts differ from the corpus construction")
    n_golden = check_golden(golden, b0, verdicts0)
    emit({"phase": "kernel", "lanes": B, "agree_all_lanes": agree,
          "max_abs_err": max_abs_err, "accepted": int(ker.sum()),
          "verdicts_match_corpus": True, "golden_lanes_checked": n_golden})

    # -- 4. the slice: the main path, kernel counts from 0 --------------------
    step = PL.make_step(dev)
    bloom = PL.AgingBloom(dev, capacity=B)  # one batch: forces a rotation
    model = DedupModel(capacity=B)
    pack_in = pack_candidates(seed=7)
    pack_dev = [put(pack_select.split_u32(a)) for a in pack_in[:4]]
    costs_dev = put(pack_in[4])
    torch.cuda.reset_peak_memory_stats(dev)
    VC.LAUNCHES = 0
    keeps, metrics = [], []
    for bt in batches:
        keep, cur, met = step(bt["msgs"], bt["lens"], bt["sigs"], bt["pubs"],
                              bt["tags2"], *bloom.buffers())
        bloom.update(cur, met)
        keeps.append(keep.cpu().numpy())
        metrics.append(met.cpu().numpy().tolist())
    ok_digest = V.verify_batch_digest(
        digests_of(batches[1]), batches[1]["sigs"], batches[1]["pubs"],
        device=dev).cpu().numpy()
    take = PL.pack_prefilter(*pack_dev, costs_dev, CU_LIMIT, TXN_LIMIT)
    sync()
    launches = VC.LAUNCHES

    for i, bt in enumerate(batches):
        want_keep, want_m = model.step(bt["tags2"], bt["ok"])
        if not np.array_equal(keeps[i], want_keep) or metrics[i] != want_m:
            raise AssertionError(f"step {i}: keep/metrics differ from the "
                                 f"host model ({metrics[i]} vs {want_m})")
        if metrics[i][0] + metrics[i][1] != B:
            raise AssertionError(f"step {i}: lanes unaccounted")
    if bloom.rotations != model.rotations or bloom.rotations < 1:
        raise AssertionError(f"rotations {bloom.rotations} vs {model.rotations}")
    if not np.array_equal(ok_digest, batches[1]["ok"]):
        raise AssertionError("verify_batch_digest verdicts differ")
    want_take = host_greedy(*pack_in, CU_LIMIT, TXN_LIMIT)
    if not np.array_equal(take.cpu().numpy(), want_take) or not want_take.any():
        raise AssertionError("pack prefilter differs from the host greedy")
    if launches < N_BATCHES + 1:
        raise AssertionError(f"verify_core launched {launches} times")
    n_golden = check_golden(golden, batches[1], ok_digest)
    emit({"phase": "slice", "steps": N_BATCHES, "metrics": metrics,
          "rotations": bloom.rotations, "golden_lanes_checked": n_golden,
          "pack_taken": int(want_take.sum()), "verify_core_launches": launches,
          "bloom_bytes_on_card": 2 * bloom.cur.numel() * 4,
          "peak_bytes_on_card": torch.cuda.max_memory_allocated(dev)})

    # -- 5. the RLC kernels against their plain versions --------------------
    zb = np.random.default_rng(2027).integers(0, 256, (B, 16), np.uint8)
    zb[:, 0] |= 1  # odd z, as verify_batch_digest_rlc forces it
    canon = lambda t: F.canonical(t.movedim(-2, 0).reshape(F.NLIMB, -1))  # noqa: E731

    def rlc_inputs(bt):
        return V.rlc_prologue(put(digests_of(bt)), put(bt["sigs"]),
                              put(bt["pubs"]), put(zb))

    p0 = rlc_inputs(b0)
    dn_in = [p0[k] for k in ("a_y", "a_sign", "r_y", "r_sign")]
    dn_ker = MSM.decompress_niels(*dn_in)
    dn_plain = MSM.decompress_niels_plain(*dn_in)
    sync()
    dn_ok_agree = bool(torch.equal(dn_ker[2], dn_plain[2]))
    dn_err = max(
        int((canon(k.reshape(3, F.NLIMB, B)) - canon(q.reshape(3, F.NLIMB, B)))
            .abs().max()) for k, q in zip(dn_ker[:2], dn_plain[:2]))
    dn_err = max(dn_err, int((dn_ker[2].int() - dn_plain[2].int()).abs().max()))
    if not dn_ok_agree or dn_err != 0:
        raise AssertionError("decompress_niels disagrees with its plain version")
    slots = MSM.slots_for(B)
    msm_in = [p0[k] for k in ("cdig", "zdig", "an3", "rn3")]
    bk_ker = MSM.msm_buckets(*msm_in)
    bk_plain = MSM.msm_buckets_plain(*msm_in, slots)
    sync()
    msm_err = int((canon(bk_ker) - canon(bk_plain)).abs().max())
    if msm_err != 0:
        raise AssertionError("msm_buckets disagrees with msm_buckets_plain")
    hb = honest_batch(batches)
    ph = rlc_inputs(hb)
    verdicts_from = {}
    for name, pp in (("batch0", p0), ("honest", ph)):
        args = [pp[k] for k in ("cdig", "zdig", "an3", "rn3")]
        verdicts_from[name] = [
            bool(MSM.msm_finalize(bk, pp["udig"]))
            for bk in (MSM.msm_buckets(*args), MSM.msm_buckets_plain(*args, slots))]
    if verdicts_from != {"batch0": [False, False], "honest": [True, True]}:
        raise AssertionError(f"msm_check verdicts {verdicts_from}")
    emit({"phase": "rlc_kernels", "lanes": B, "slots": slots,
          "decompress_niels": {"ok_agree_all_lanes": dn_ok_agree,
                               "max_abs_err_canonical": dn_err,
                               "decompressed": int(dn_ker[2].sum())},
          "msm_buckets": {"bucket_sets": MSM.NWIN * slots,
                          "max_abs_err_canonical": msm_err,
                          "compared": "every bucket coordinate after F.canonical"},
          "msm_check_verdicts_kernel_vs_plain": verdicts_from})

    # -- 6. the RLC path: three batches, kernel counts from 0 ----------------
    tb = torsion_batch(golden, hb)
    cases = [("honest", hb), ("batch0", b0), ("torsion", tb)]
    per_sig = {name: V.verify_batch_digest(digests_of(bt), bt["sigs"], bt["pubs"],
                                           device=dev).cpu().numpy()
               for name, bt in cases}
    equation = []
    impl = V._verify_digest_rlc_impl

    def recording_impl(*args, **kw):  # records the batch equation's verdict
        lane_ok, batch_ok = impl(*args, **kw)
        equation.append(bool(batch_ok))
        return lane_ok, batch_ok

    def counts():
        return dict(MSM.LAUNCHES, verify_core=VC.LAUNCHES)

    V._verify_digest_rlc_impl = recording_impl
    VC.LAUNCHES = 0
    for k in MSM.LAUNCHES:
        MSM.LAUNCHES[k] = 0
    rlc_out = {}
    try:
        for name, bt in cases:
            before = counts()
            got = V.verify_batch_digest_rlc(digests_of(bt), bt["sigs"], bt["pubs"],
                                            zbytes=zb, device=dev).cpu().numpy()
            after = counts()
            rlc_out[name] = (got, equation[-1],
                             {k: after[k] - before[k] for k in after})
    finally:
        V._verify_digest_rlc_impl = impl
    sync()
    rlc_launches = counts()
    if min(rlc_launches.values()) < 1:
        raise AssertionError(f"a kernel of the RLC path did not launch: {rlc_launches}")
    rlc_report = {}
    for name, bt in cases:
        got, batch_ok, launched = rlc_out[name]
        want_batch_ok = name == "honest"
        if batch_ok != want_batch_ok:
            raise AssertionError(f"{name}: batch_ok {batch_ok}")
        if not np.array_equal(got, bt["ok"]) or not np.array_equal(got, per_sig[name]):
            raise AssertionError(f"{name}: verdicts differ from the corpus or "
                                 "the per-signature path")
        # verify_core: the gate runs only when the equation holds (honest,
        # torsion); the strict path runs when batch_ok fails (batch0, torsion)
        want_launched = {"decompress_niels": 1, "msm_buckets": 1,
                         "verify_core": 2 if name == "torsion" else 1}
        if launched != want_launched:
            raise AssertionError(f"{name}: launches {launched}")
        if name == "torsion":
            n_golden = check_golden_lanes(golden, bt, got,
                                          [*TORSION_LANES, 0, B // 3, B - 1])
        else:
            n_golden = check_golden(golden, bt, got)
        rlc_report[name] = {"batch_ok": batch_ok, "accepted": int(got.sum()),
                            "verdicts_match_per_sig": True,
                            "verdicts_match_corpus": True,
                            "golden_lanes_checked": n_golden,
                            "launches": launched}
    emit({"phase": "rlc", "lanes": B, "batches": rlc_report,
          "launches": rlc_launches})

    # -- 7. times -------------------------------------------------------------
    bt = batches[2]
    t = {k: put(bt[k]) for k in ("msgs", "sigs", "pubs")}
    lens_d = put(bt["lens"].astype(np.int64))
    tags_d = put(bt["tags2"].astype(np.int64))
    dig_d = put(digests_of(bt))
    ok_d, *core_d = V.prologue(dig_d, t["sigs"], t["pubs"])
    cur_d, prev_d = PL.fresh_bloom(dev), PL.fresh_bloom(dev)
    h = {k: put(hb[k]) for k in ("sigs", "pubs")}
    hdig, hz = put(digests_of(hb)), put(zb)
    dn_h = [ph[k] for k in ("a_y", "a_sign", "r_y", "r_sign")]
    msm_h = [ph[k] for k in ("cdig", "zdig", "an3", "rn3")]
    bk_h = MSM.msm_buckets(*msm_h)
    ms = {
        "sha512": cuda_ms(lambda: V.message_digests(
            t["msgs"], lens_d, t["sigs"], t["pubs"]), reps=5),
        "prologue": cuda_ms(lambda: V.prologue(
            dig_d, t["sigs"], t["pubs"]), reps=5),
        "verify_core": cuda_ms(lambda: VC.verify_core(*core_d), reps=20),
        "dedup": cuda_ms(lambda: PL.dedup(ok_d, tags_d, cur_d, prev_d), reps=5),
        "pack": cuda_ms(lambda: PL.pack_prefilter(
            *pack_dev, costs_dev, CU_LIMIT, TXN_LIMIT), reps=3),
        "verify_core_plain": cuda_ms(
            lambda: VC.verify_core_plain(*core_d), reps=3),
        "verify_batch_digest": cuda_ms(lambda: V.verify_batch_digest(
            dig_d, t["sigs"], t["pubs"], device=dev), reps=5),
        "verify_batch": cuda_ms(lambda: V.verify_batch(
            t["msgs"], lens_d, t["sigs"], t["pubs"], device=dev), reps=5),
        "step": cuda_ms(lambda: step(
            t["msgs"], lens_d, t["sigs"], t["pubs"], tags_d, cur_d, prev_d),
            reps=3),
        # the RLC path, on the honest batch (the accept branch)
        "rlc_prologue": cuda_ms(lambda: V.rlc_prologue(
            hdig, h["sigs"], h["pubs"], hz), reps=5),
        "decompress_niels": cuda_ms(lambda: MSM.decompress_niels(*dn_h), reps=20),
        "decompress_niels_plain": cuda_ms(
            lambda: MSM.decompress_niels_plain(*dn_h), reps=3),
        "msm_buckets": cuda_ms(lambda: MSM.msm_buckets(*msm_h), reps=20),
        "msm_buckets_plain": cuda_ms(
            lambda: MSM.msm_buckets_plain(*msm_h, slots), reps=3),
        "msm_finalize": cuda_ms(lambda: MSM.msm_finalize(bk_h, ph["udig"]), reps=3),
        "rlc_gate": cuda_ms(lambda: V._torsion_free_pair(*dn_h), reps=10),
        "verify_batch_digest_rlc": cuda_ms(lambda: V.verify_batch_digest_rlc(
            hdig, h["sigs"], h["pubs"], hz, device=dev), reps=3),
        "verify_batch_digest_honest": cuda_ms(lambda: V.verify_batch_digest(
            hdig, h["sigs"], h["pubs"], device=dev), reps=5),
    }
    vc_bound = bound(VC.products_per_lane() * B,
                     nbytes(*core_d) + B + VC.kernel_consts().nbytes)
    dn_bound = bound(MSM.decompress_niels_products_per_lane() * B,
                     nbytes(*dn_h, *dn_ker) + VC.kernel_consts().nbytes)
    msm_bound = bound(MSM.msm_products(ph["cdig"], ph["zdig"]),
                      nbytes(*msm_h, bk_h))
    bounds = {"verify_core": vc_bound, "decompress_niels": dn_bound,
              "msm_buckets": msm_bound}
    for name, bd in bounds.items():
        bd["bound_share"] = bd["bound_ms"] / ms[name]
    emit({"phase": "times", "lanes": B, "ms": ms,
          "verifies_per_s": {
              "verify_batch_digest": B / ms["verify_batch_digest"] * 1e3,
              "verify_batch": B / ms["verify_batch"] * 1e3,
              "verify_batch_digest_rlc": B / ms["verify_batch_digest_rlc"] * 1e3,
              "verify_batch_digest_honest":
                  B / ms["verify_batch_digest_honest"] * 1e3},
          "bounds": bounds,
          "card": smi, "seconds_total": time.time() - t_start})

    src = "firedancer_tpu_torch/csrc/"
    tpu = "firedancer_tpu/ops/ed25519/"
    rows = [
        ("verify_core", "verify_core.cu", "pallas_kernel.py:70", launches, max_abs_err),
        ("decompress_niels", "decompress_niels.cu", "msm_kernel.py:119",
         rlc_launches["decompress_niels"], dn_err),
        ("msm_buckets", "msm.cu", "msm_kernel.py:178",
         rlc_launches["msm_buckets"], msm_err),
    ]
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": src + file,
        "replaces": tpu + where, "launches": n, "max_abs_err": err,
        "ms": ms[name], "plain_ms": ms[name + "_plain"],
        "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
        "library_ms": None,
    } for name, file, where, n, err in rows]})
    print(nvidia_smi_line(), flush=True)
    return {"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device on this host", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    emit(run(torch.device("cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
