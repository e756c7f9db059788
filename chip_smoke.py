#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (firedancer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's device ingress step (SHA-512 -> Ed25519 verify with the
hand-written verify_core kernel -> aging-bloom dedup -> pack prefilter on
the hand-written pack_select kernel) and
its batch (RLC) verify path (verify_batch_digest_rlc: the decompress_niels
and msm_buckets kernels, the plain finalization, the verify_core subgroup
gate) at deployment size: B = 4096 lanes per batch, 1232-byte messages, the
full 2 x 2^28-bit filter pair resident on the card, K = 1024 pack
candidates of 1024 account bits.  Phases, one JSON line each:

  device       card name, power limit, TF32 switches (both set off)
  build        every kernel and probe built from csrc/ by utils/kbuild.py, in
               parallel; ptxas's registers, shared memory, stack frame and
               spills per kernel; the tile runtime's host ring library built
               from tango/native/ by utils/cbuild.py
  sass         the multiply instructions of one fe_mul and one fe_sq in
               their SASS (cuobjdump -sass of csrc/probe/fe_probe.cu), the
               card's measured issue rate of IMAD.WIDE and of IMAD, and the
               cycles of one dependent fe_sq and fe_mul on one warp; the
               instructions of msm_buckets' step loop
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
               and the products its threads run (kernel_int32_multiply_adds)
  lanes_sweep  verify_core at B = 4096, 8192, 16384, decompress_niels and
               msm_buckets at 4096, 8192 (the batch tiled), each beside its
               bound: time grows about linearly with B once the card is
               full; and msm_buckets and msm_finalize at S = 128, 256, 512
               lane slots on the valid batch, the kernel held against its
               plain version and the batch verdict checked at each S
  pack_select  the pack_select kernel against select_plain on the card and
               the host greedy on pack_candidates(seed=7) (K = 1024, W2 =
               32) and on edge cases (K = 1, all PAD_COST rows, cu_limit 0,
               non-zero in-use sets, takes at live rows 31 and 32, K not a
               multiple of 32, W2 of 1, 2, 33 and 300 over two segments,
               txn_limit 1, a budget spent exactly, zero-cost rows under
               cu_limit 0, in-use conflicts on most rows), through
               select_impl and (even W2) the pack tile's Selector; the
               chain's steps per case, each within ceil(live / 32) + takes
               (one more a segment after the first); the kernel's
               CUDA-event ms around one call (the kernels line's ms, the
               method of every row) and its device ms with 20 launches
               queued behind a spin (device_ms_queued), the plain
               version's, the bound (bytes against word operations) and
               the chain floor (steps without and with a take times the
               probe's cycles for each, at the card's maximum SM clock;
               edge cases and the bound from tests/torch_pack_cases.py),
               the kernel's own clock64 cycles by
               phase; the Selector's host ms per call, and a select issued
               while a spin is queued on the legacy default stream must
               return before the spin ends

and the rest of ops/, each at the size its users run:

  sha256_sass  per SHA-256 kernel, the loop of one block's compression in
               its SASS: instructions by opcode and the critical path (the
               longest chain of dependent instructions, and per round);
               csrc/probe/sha_probe.cu's clock64 cycles of one dependent
               SHF.R.W, LOP3, IADD3 and IMAD and of the round's SHF.R.W ->
               LOP3 -> IADD3 step, and a lone warp's cycles per instruction
               over 8 independent chains; the opcodes of each probe loop
  sha256       the corpus's 4096 messages through sha256 (the
               fdt_sha256_blocks kernel on the bytes: one launch), every
               lane held against hashlib; the device kernels of one call
               by torch.profiler (sha256_profile, the line before: exactly
               one fdt_sha256_blocks a call); the 32- and 64-byte word forms
               on 4096 lanes; the kernel against sha256_bytes_plain on all
               lanes; the raw launch's ms (200 launches between two events)
               beside one wrapper call and the entry point, and at the
               widths 66 (a Merkle layer's node pairs) and 1231, whose rows
               start at every offset of a 16-byte granule; the issue bound
               (the operations of FIPS 180-4's compression on the ALU and
               FMA pipes, not the kernel's instructions), the latency floor (the longest lane's 20 compressions x 64
               rounds x the probe's SHF + LOP3 + IADD3 cycles at the
               maximum SM clock) and the self-measured chain floor (one lane's
               time a compression)
  poh          one slot built with hashlib on the host: 64 ticks of 12,500
               hashes in 1,024 entries (15 mixin entries and one tick entry
               per tick), verified by verify_entries (one launch of the
               fdt_poh_chain kernel on 32-byte states, its device kernels
               profiled), every end state held against the host chain; one
               lane appended 12,500 times against hashlib (and timed: the
               self-measured chain floor); the kernel against
               poh_chain_bytes_plain on all lanes at max_hashcnt 64; the raw
               launch's ms (10 launches) beside one wrapper call and
               verify_entries; the issue bound and the latency floor; the
               probe's cycles of one dependent compression, the compression
               before its redesign and sha256.cuh's, in turns (old, new,
               new, old), every lane against hashlib
  reedsol      128 full 32:32 FEC sets side by side (4,096 data shreds of
               the 1,019-byte coded width) encoded and held against
               _encode_host; recovered from three seeded 32-row losses (one
               keeps only parity rows); 31 survivors give None
  sign         sign_many over 4096 distinct keys and messages, every
               signature held against golden.sign
  keccak_blake3  keccak256 of the corpus's 4096 messages (256 seeded lanes
               against digest_host), blake3 of 4096 messages of 0-1024
               bytes (256 lanes against the CPU run, the empty-input vector)

and the multi-device layer:

  dist_step    the step as the one rank of an NCCL group (dp = mp = 1) on the
               corpus batches: keep, metrics and every filter word equal to
               the single-card step's; batch 1 run twice on the same buffers
               gives the same answer (a pool's resubmit); ms per step beside
               the single-card step, and the step's fresh 32 MiB filter copy
  pool         run_verify_pool over local_device_count() CUDA domains, eight
               4096-lane corpus batches in the digest form: in-order landing,
               verdicts equal to the direct call, one verify_core launch per
               batch, no fallback, no device error; then a lone domain that
               raises on its first dispatch, at 64 lanes: quarantined, and
               the pool raises DomainsOut (a card's batch never lands on the
               host); ms per batch through the pool beside the direct call
  tiles        the ingress tile pipeline through the port's entry
               (entry.ingress): synth -> verify (VerifyTile at 4096 lanes x
               1232 bytes, pad_full, no pre-dedup, one card) -> dedup (depth
               2^20) -> sink in the thread runtime, a 512-txn pool with 10%
               corrupted signatures streamed as 65,536 frags (128 passes,
               16 full device batches); held exactly: every tile's counters
               against the pool's good mask, survivors and payloads byte for
               byte, 16 device batches, 16 verify_core launches after the
               one warm-up, no fallback; run at the run loop's default idle
               sleep (50 us) and at 1 ms, and once more at 1 ms under
               torch.profiler for the card's kernel-time share; txns/s, e2e
               p50/p99 at the sink, the verify hop's p99, ms per device
               batch from the pool's dispatch and land stamps, and the busy
               shares
  leader       the leader pipeline through entry.leader: synth -> verify ->
               dedup -> pack (depth 4096, K = 1024 over 1024 account bits,
               2 ms cadence, 31 txns and 1.5M CU a microblock, its select
               on the pack_select kernel) -> bank x 2 (fee-only) -> sink x
               2, the tiles phase's pool and frags; three runs: select on at
               the run loop's default idle sleep and at 1 ms, select off at
               1 ms; held exactly: verify and dedup as in tiles, 466 txns
               inserted and executed, 466 x 5000 lamports of fees,
               completions == microblocks, the engine drained, the sinks'
               microblocks hold the good pool's payloads once each with no
               conflicting pair, pack_select launches == select calls,
               every call's chain steps within its bound, and the first
               select calls' inputs held kernel against plain and host;
               txns/s, microblocks, txns per microblock, e2e at the sinks,
               the select call's host ms (median, max) and its share of the
               wall time, the chain's steps per call, the pack engine's
               schedule calls and host seconds (all, and the device-select
               part)
  bench        python -m firedancer_tpu_torch.bench in a subprocess: one JSON
               line with bench.py's keys; then --mode pipeline (replay ->
               verify -> dedup -> sink, bench.py's sizes) at a 1 ms idle
               sleep: verify_path_tps and the latency keys
  configure    the port's device stage, which must report ok

then a `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failure raises: the script exits
non-zero and prints no result.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import re
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
# 67 TFLOP/s FP32 = 33.5e12 FMA/s; a 32-bit integer multiply-add (IMAD)
# issues at half the FP32 FMA rate on compute capability 9.0 (the
# throughput table of NVIDIA's CUDA C++ Programming Guide)
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
# A 32x32->64 multiply-add (IMAD.WIDE, one limb product of the kernels)
# issues at half the IMAD rate: the sass phase's rate probe measures
# 6.5e12 IMAD.WIDE/s against 15.7e12 IMAD/s on an H100 at 700 W.  The
# bounds count limb products at this rate.
WIDE_MAD_PER_S = INT32_MAD_PER_S / 2
#: the probes under csrc/probe/, built beside the kernels
PROBES = ["probe/fe_probe", "probe/sha_probe"]
#: csrc/msm.cu's kernel, as cuobjdump names it
MSM_KERNEL_SYMBOL = "_Z18msm_buckets_kernelPKiS0_S0_S0_Piii"
# 32-bit integer add, logic and shift instructions issue at 64 per clock per
# SM on compute capability 9.0 (the throughput table of NVIDIA's CUDA C++
# Programming Guide), the IMAD rate: 132 SMs at 1.98 GHz.  The SHA-256
# kernels' bounds count the instructions of their SASS at this rate.
INT32_OPS_PER_S = INT32_MAD_PER_S
#: a slot: 64 ticks of Agave's DEFAULT_HASHES_PER_TICK (2,000,000 hashes/s
#: over 160 ticks/s), 16 entries per tick (15 with a mixin, then the tick)
SLOT_TICKS, HASHES_PER_TICK, ENTRIES_PER_TICK = 64, 12_500, 16
#: the hash count at which the PoH kernel is held against its plain version
POH_PLAIN_MAX = 64
#: full 32:32 FEC sets of 31,200 payload bytes: each shred's coded width is
#: the shredder's parity payload at Merkle depth 6 (disco/shredder.py:
#: 1115 - 20 * 6 + 88 - 0x40 = 1,019 bytes)
FEC_SETS, FEC_DATA, FEC_WIDTH = 128, 32, 1019
#: lanes held against the host oracles (keccak256, blake3)
CHECK_LANES = 256


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


def _golden_sign_chunk(items):
    """Worker: golden.sign of (secret, message) pairs."""
    sys.path.insert(0, ROOT)
    from firedancer_tpu_torch.ops.ed25519 import golden

    return [golden.sign(sk, m) for sk, m in items]


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
    products at the card's IMAD.WIDE rate and its bytes at the card's
    memory rate."""
    ops_ms = products / WIDE_MAD_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"int32_multiply_adds": products, "ops_ms": ops_ms,
            "bytes": nbytes, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _kernel_name(sym: str) -> str:
    """`verify_core_kernel` of an Itanium-mangled `_Z18verify_core_kernelPKi...`,
    `pack_select_kernel<8,1>` of a template's `_Z18pack_select_kernelILi8ELb1EEv...`
    (an extern "C" name as it is)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    name = sym[m.end(): m.end() + int(m.group(1))]
    t = re.match(r"I((?:L[a-z]\d+E)+)E", sym[m.end() + int(m.group(1)):])
    return f"{name}<{','.join(re.findall(r'L[a-z](\d+)E', t.group(1)))}>" if t else name


def ptxas_summary(log: str) -> dict:
    """Per kernel of a -Xptxas -v log: registers, shared memory, stack
    frame and spill bytes."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = out.setdefault(_kernel_name(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def _instructions(sass: str, function: str) -> list:
    """(address, opcode, operands) of each instruction of one function's
    SASS (cuobjdump -sass)."""
    body = sass.split(f"Function : {function}\n", 1)[1].split("Function : ", 1)[0]
    return [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", body)]


def _imad_counts(ops: list) -> dict:
    """Every IMAD form by its full mnemonic, and the instruction total."""
    counts = {op: ops.count(op) for op in sorted(set(ops)) if op.startswith("IMAD")}
    counts["instructions"] = len(ops)
    return counts


def sass_counts(sass: str, function: str) -> dict:
    """Opcode counts of one function's SASS."""
    return _imad_counts([op for _, op, _ in _instructions(sass, function)])


def loop_counts(sass: str, function: str) -> dict:
    """Opcode counts of the longest loop of one function's SASS: the code
    from a backward branch's target to the branch."""
    ins = _instructions(sass, function)
    lo = hi = 0
    for addr, op, rest in ins:
        m = re.match(r"\s*0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and addr - int(m.group(1), 16) > hi - lo:
            lo, hi = int(m.group(1), 16), addr
    return _imad_counts([op for addr, op, _ in ins if lo <= addr <= hi])


def _loops(ins: list) -> list:
    """(first, last) addresses of every loop of one function's SASS: a
    backward branch's target and the branch, longest first."""
    out = []
    for addr, op, rest in ins:
        m = re.match(r"\s*0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            out.append((int(m.group(1), 16), addr))
    return sorted(out, key=lambda lh: lh[0] - lh[1])


def _dest_regs(op: str, rest: str) -> list:
    """Registers an instruction writes: its first operand where that is a
    register (two for a .64 or WIDE result, four for .128)."""
    m = re.match(r"\s*R(\d+)\b", rest)
    if not m:
        return []
    n = 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1
    return [str(int(m.group(1)) + i) for i in range(n)]


def _critical_path(ins: list) -> int:
    """The longest chain of dependent instructions through `ins` (straight
    line, in order; registers live on entry count as ready)."""
    depth, best = {}, 0
    for _, op, rest in ins:
        dst = _dest_regs(op, rest)
        srcs = re.findall(r"\bR(\d+)\b", rest)[len(dst[:1]):]
        d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
        for r in dst:
            depth[r] = d
        best = max(best, d)
    return best


def loop_profile(sass: str, function: str, rounds: int = 64) -> dict:
    """The loops of a SHA-256 kernel's SASS, each one pass a block: per
    loop its instructions by opcode, its critical path (the longest chain
    of dependent instructions in one pass) and its warp (the schedule warp
    stores a block's 48 or 64 words of W + K to shared memory, 16 or more
    STS, the round warp at most its 8 state words); in all, the
    instructions of one block's compression (a pass of each warp's loop,
    the larger where ptxas compiled a warp's loop twice) and the longest
    critical path, also per round.  A diagnostic: the static count holds
    code a pass may skip (a lane's padding), and no bound uses it."""
    ins = _instructions(sass, function)
    loops = []
    for lo, hi in sorted(_loops(ins)):
        body = [i for i in ins if lo <= i[0] <= hi]
        ops = [op.split(".")[0] for _, op, _ in body]
        loops.append({"warp": "schedule" if ops.count("STS") >= 16 else "round",
                      "instructions": len(body),
                      "by_opcode": {o: ops.count(o) for o in sorted(set(ops))},
                      "critical_path": _critical_path(body)})
    per_warp = {}
    for lp in loops:
        per_warp[lp["warp"]] = max(per_warp.get(lp["warp"], 0), lp["instructions"])
    path = max(lp["critical_path"] for lp in loops)
    return {"instructions": sum(per_warp.values()), "instructions_by_warp": per_warp,
            "loops": loops, "critical_path": path, "critical_path_per_round": path / rounds}


def all_loop_counts(sass: str, function: str) -> list:
    """Opcode counts of every loop of one function, in address order."""
    ins = _instructions(sass, function)
    out = []
    for lo, hi in sorted(_loops(ins)):
        ops = [op.split(".")[0] for a, op, _ in ins if lo <= a <= hi]
        out.append({o: ops.count(o) for o in sorted(set(ops))})
    return out


def probe_rates(dev) -> dict:
    """Multiply-adds per second of the whole card, IMAD.WIDE and IMAD, from
    csrc/probe/fe_probe.cu's rate kernel (132 x 16 blocks of 256 threads, 8
    independent chains of 2048 multiply-adds per thread), and the cycles
    of one dependent fe_sq and fe_mul (one warp, chains of 4096)."""
    import ctypes

    import torch

    from firedancer_tpu_torch.utils import kbuild

    fn = kbuild.load("probe/fe_probe").fdt_probe_rate_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, threads, iters, chains = 132 * 16, 256, 2048, 8
    src = torch.arange(1, 65, dtype=torch.int32, device=dev)
    out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for name, wide in (("imad_wide", 1), ("imad", 0)):
        def launch():
            if fn(wide, src.data_ptr(), out.data_ptr(), iters, blocks, threads, stream):
                raise RuntimeError("probe launch failed")
        ms = cuda_ms(launch, reps=5)
        rates[name + "_per_s"] = blocks * threads * chains * iters / (ms * 1e-3)
    # one warp, a chain of dependent products: cycles per product
    lat = kbuild.load("probe/fe_probe").fdt_probe_latency_launch
    lat.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lat.restype = ctypes.c_int
    elems = torch.randint(-(1 << 25), 1 << 25, (640,), dtype=torch.int32, device=dev)
    res = torch.empty(320, dtype=torch.int32, device=dev)
    cyc = torch.empty(32, dtype=torch.int64, device=dev)
    n = 4096
    for name, kind in (("fe_sq", 0), ("fe_mul", 1)):
        if lat(elems.data_ptr(), res.data_ptr(), cyc.data_ptr(), n, kind, stream):
            raise RuntimeError("probe launch failed")
        sync()
        rates[name + "_dependent_cycles"] = int(cyc.max()) / n
    return rates


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


def pack_bound(K: int, W2: int) -> dict:
    """The least time of a K-candidate scan over W2-word rows: its bytes
    (each candidate's two rows and cost, the in-use words, the take mask)
    at the memory rate against its word operations (per candidate and
    word two ANDs and two ORs for the conflict, two ORs for the take) at
    the 32-bit integer rate."""
    nbytes_ = 2 * K * W2 * 4 + 2 * W2 * 4 + 8 * K + K
    ops = 6 * K * W2
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
    return {"bytes": nbytes_, "bytes_ms": bytes_ms, "int32_ops": ops, "ops_ms": ops_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


#: chip_smoke's pack_select edge cases: name -> (tests/torch_pack_cases.py
#: case, K, W2): takes at live rows 31 and 32 (the last of a window and the
#: first of the next), K not a multiple of 32, W2 of 1, 2, 33 and 300 (two
#: segments), txn_limit 1, a budget spent exactly, zero-cost rows under
#: cu_limit 0, and in-use conflicts on most rows
PACK_EDGE_CASES = {
    "take_at_31": ("take_at_31", 1024, 32), "take_at_32": ("take_at_32", 1024, 32),
    "k1000_w32": ("random", 1000, 32), "k97_w1": ("random", 97, 1),
    "k300_w2": ("random", 300, 2), "k100_w33": ("random", 100, 33),
    "k4173_w300": ("random", 4096 + 77, 300), "txn_limit_1": ("txn_limit_1", 1024, 32),
    "budget_exact": ("budget_exact", 1024, 32),
    "zero_cost_cu_limit_0": ("zero_cost_cu_limit_0", 1024, 32),
    "in_use_most": ("in_use_most", 1024, 32)}


def pack_cases_module():
    """tests/torch_pack_cases.py: the seeded edge cases and the chain's
    step bound, shared with the tests."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_pack_cases

    return torch_pack_cases


def phase_pack_select(dev, put) -> dict:
    """The pack_select kernel against select_plain on the card and the host
    greedy, at the deployment shape (pack_candidates: K = 1024, W2 = 32)
    and on edge cases, through select_impl and through the pack tile's
    Selector (u64 rows); the chain's steps per call against its bound;
    times, the bound and the chain floor; the selector's host ms and its
    stream's independence from the legacy default stream; -> the kernel's
    row of the kernels line (launches filled in by the leader phase, the
    main path)."""
    import torch

    from firedancer_tpu_torch.bench_select import cuda_ms_queued
    from firedancer_tpu_torch.ops import pack_select as PS

    rw, wr, in_rw, in_w, costs = pack_candidates(seed=7)
    pad = costs.copy()
    pad[:] = PS.PAD_COST
    in_w2 = in_w.copy()
    in_w2[5] = np.uint64(0xFFFF0000)
    u32 = lambda a: np.ascontiguousarray(a).view(np.uint32)  # noqa: E731
    cases = {name: tuple(u32(x) for x in c[:4]) + c[4:] for name, c in {
        "deployment": (rw, wr, in_rw, in_w, costs, CU_LIMIT, TXN_LIMIT),
        "k1": (rw[:1], wr[:1], in_rw, in_w, costs[:1], CU_LIMIT, TXN_LIMIT),
        "all_pad_cost": (rw, wr, in_rw, in_w, pad, CU_LIMIT, TXN_LIMIT),
        "cu_limit_0": (rw, wr, in_rw, in_w, costs, 0, TXN_LIMIT),
        "in_use_rw_and_w": (rw, wr, in_rw | in_w2, in_w2, costs, CU_LIMIT, TXN_LIMIT),
    }.items()}
    PC = pack_cases_module()
    for name, (case, K, W2) in PACK_EDGE_CASES.items():
        c = PC.edge_case(case, K, W2, seed=K + W2)
        cases[name] = tuple(u32(x) for x in c[:4]) + c[4:]
    before = PS.LAUNCHES
    launches = 0
    checked, steps, err = {}, {}, 0
    dev_in = stats_dep = None
    for name, (a, b, c, d, e, cu, tl) in cases.items():
        args = [put(x.view(np.int32)) for x in (a, b, c, d)] + [put(e.astype(np.int64))]
        stats = torch.full((4,), -1, dtype=torch.int64, device=dev)
        ker = PS.select_impl(*args, cu, tl, stats=stats)
        plain = PS.select_plain(*args, cu, tl)
        sync()
        launches += 1
        host = host_greedy(a, b, c, d, e, cu, tl)
        got = ker.cpu().numpy()
        err = max(err, int((ker.int() - plain.int()).abs().max()) if len(e) else 0)
        if not (np.array_equal(got, plain.cpu().numpy()) and np.array_equal(got, host)):
            raise AssertionError(f"pack_select {name}: kernel, plain and host differ")
        n_steps = int(stats[0])
        if n_steps > PC.step_bound(a, b, c, d, e, cu, tl, host):
            raise AssertionError(f"pack_select {name}: {n_steps} steps over the bound")
        if a.shape[1] % 2 == 0:  # the selector's u64 rows
            sel = PS.Selector(len(e), a.shape[1] // 2, dev)
            via = sel(*(x.view(np.uint64) for x in (a, b, c, d)), e, cu, tl)
            launches += 1
            if not np.array_equal(via, host) or sel.stats[0] != n_steps:
                raise AssertionError(f"pack_select {name}: the selector differs")
        checked[name] = int(host.sum())
        steps[name] = n_steps
        if name == "deployment":
            dev_in, stats_dep = args, stats.cpu().tolist()
    if (checked["all_pad_cost"] or checked["cu_limit_0"] or not checked["deployment"]
            or checked["take_at_31"] != 2 or checked["take_at_32"] != 2):
        raise AssertionError(f"pack_select takes {checked}")
    if PS.LAUNCHES - before != launches:
        raise AssertionError(f"pack_select launched {PS.LAUNCHES - before} times "
                             f"for {launches} kernel calls")
    K, W2 = dev_in[0].shape
    takes = checked["deployment"]
    ms = {"kernel_queued": cuda_ms_queued(
              lambda: PS.select_impl(*dev_in, CU_LIMIT, TXN_LIMIT)),
          "kernel_one_call": cuda_ms(
              lambda: PS.select_impl(*dev_in, CU_LIMIT, TXN_LIMIT), reps=50),
          "plain": cuda_ms(lambda: PS.select_plain(*dev_in, CU_LIMIT, TXN_LIMIT), reps=3)}
    bd = pack_bound(K, W2)
    mhz = max_sm_clock_mhz()
    no_take, take_step = (PS.chain_probe_cycles(1 << 16, dev, take_steps=f)
                          for f in (False, True))
    n_steps = steps["deployment"]
    chain_cycles = (n_steps - takes) * no_take + takes * take_step
    bd.update({"chain_steps": n_steps, "chain_takes": takes,
               "chain_cycles_per_step": {"no_take": no_take, "take": take_step},
               "chain_floor_ms": chain_cycles / (mhz * 1e3),
               "kernel_cycles": {"phase1_and_staging": stats_dep[1],
                                 "chain": stats_dep[2], "total": stats_dep[3]},
               # the kernel's clock64 cycles over its queued device time (the
               # time holds the gap between two launches too)
               "clock_mhz_in_queued_launch": stats_dep[3] / (ms["kernel_queued"] * 1e3)})
    # the shares of the kernels line's ms (one call, as every row is timed)
    # and of the device time queued behind a spin
    for key, t in (("", ms["kernel_one_call"]), ("_queued", ms["kernel_queued"])):
        bd["bound_share" + key] = bd["bound_ms"] / t
        bd["chain_floor_share" + key] = bd["chain_floor_ms"] / t
    # the pack tile's call: numpy in, one copy each way on its own stream
    sel = PS.Selector(K, W_PACK, dev)
    sel.ready()
    args64 = (rw, wr, in_rw, in_w, costs, CU_LIMIT, TXN_LIMIT)
    call_ms = []
    for _ in range(200):
        t0 = time.perf_counter()
        sel(*args64)
        call_ms.append((time.perf_counter() - t0) * 1e3)
    # a select while a ~1 s spin is queued on the legacy default stream
    # must return before the spin ends
    want = sel(*args64)
    sync()
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    got = sel(*args64)
    during_ms = (time.perf_counter() - t0) * 1e3
    default_busy = not torch.cuda.default_stream(dev).query()
    sync()
    if not default_busy or not np.array_equal(got, want):
        raise AssertionError("a select waited for the legacy default stream")
    emit({"phase": "pack_select", "K": K, "W2": W2, "cases_taken": checked,
          "steps": steps, "max_abs_err": err, "ms": ms, "bound": bd,
          "max_sm_clock_mhz": mhz, "ns_per_candidate": ms["kernel_one_call"] * 1e6 / K,
          "selector_call_ms": {"median": statistics.median(call_ms),
                               "max": max(call_ms)},
          "select_during_default_stream_spin_ms": during_ms,
          "card": nvidia_smi_line()})
    return {"name": "pack_select", "route": "cuda",
            "source": "firedancer_tpu_torch/csrc/pack_select.cu",
            "replaces": "firedancer_tpu/ops/pack_select.py:46", "launches": None,
            "max_abs_err": err, "ms": ms["kernel_one_call"], "plain_ms": ms["plain"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"], "library_ms": None,
            "chain_floor_ms": bd["chain_floor_ms"], "device_ms_queued": ms["kernel_queued"]}


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


# ---------------------------------------------------------------------------
# the rest of ops/: PoH, SHA-256, Reed-Solomon, signing, Keccak-256, BLAKE3
# ---------------------------------------------------------------------------

BLAKE3_EMPTY = "af1349b9f5f9a1a6a0404dea36dcc9499bcb25c9adc112b7cc9a93cae41f3262"


def bytes_max_err(a, b) -> int:
    """Largest |difference| of two uint8 tensors, byte by byte."""
    return int((a.cpu().int() - b.cpu().int()).abs().max()) if a.numel() else 0


def _sum_terms(ops: dict, n: int, const: bool) -> bool:
    """Adds that sum n variable terms and, where `const`, one constant (an
    immediate): three-input adds while three terms are left, then one of
    two inputs.  -> whether the sum is variable."""
    terms = n + const
    while n and terms > 1:
        key = "add3" if terms >= 3 else "add2"
        ops[key] += 1
        terms -= 2 if key == "add3" else 1
    return n > 0


def sha_compression_ops(const_words=(), const_state: bool = False) -> dict:
    """The operations of one SHA-256 compression, counted from FIPS 180-4's
    functions and not from a kernel's code.  Per round: Σ1(e) and Σ0(a)
    (three rotates and one three-way xor each), Ch and Maj (one
    three-input logic operation each), and the adds p = h + W + K,
    T1 = p + Σ1 + Ch, e' = T1 + d, a' = T1 + Σ0 + Maj; per schedule step
    σ0 and σ1 (two rotates, a shift and one xor each) and the sum of four
    terms; then the eight adds of the state.  An operation whose inputs are
    all constant folds away: `const_words` are message words known before
    the run (the padding half of a PoH append), `const_state` a compression
    from the initial state.  -> {"alu": rotates, shifts and logic, which
    only the ALU pipe runs; "add2", "add3": adds of two and of three
    inputs, which either pipe runs (IADD3; one or two IMADs)}."""
    ops = {"alu": 0, "add2": 0, "add3": 0}
    w = [i not in const_words for i in range(16)]
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        ops["alu"] += 4 * w15 + 4 * w2
        terms = [w[t - 16], w15, w[t - 7], w2]
        w.append(_sum_terms(ops, sum(terms), not all(terms)))
    a, b, c, d, e, f, g, h = [not const_state] * 8
    for t in range(64):
        ch, mj = e or f or g, a or b or c
        ops["alu"] += 4 * e + ch + 4 * a + mj
        p = _sum_terms(ops, h + w[t], True)
        t1 = _sum_terms(ops, p + e + ch, not (p and e and ch))
        e2 = _sum_terms(ops, t1 + d, not (t1 and d))
        a2 = _sum_terms(ops, t1 + a + mj, not (t1 and a and mj))
        a, b, c, d, e, f, g, h = a2, a, b, c, e2, e, f, g
    ops["add2"] += 8
    return ops


def sha_ops(*parts) -> dict:
    """Sums of (count, ops) parts: -> ops of the whole run."""
    out = {"alu": 0, "add2": 0, "add3": 0}
    for count, ops in parts:
        for k in out:
            out[k] += count * ops.get(k, 0)
    return out


def pipe_split(ops: dict) -> tuple:
    """The least issue of `ops` on one SM sub-partition's two integer pipes,
    each at INT32_OPS_PER_S over the card: the ALU pipe runs every
    operation, the FMA pipe only adds (IMAD: one for a two-input add, two
    for three).  Adds move to the FMA pipe, two-input ones first, until the
    pipes balance.  -> (ALU pipe ops, FMA pipe ops); the bound is the
    larger."""
    alu, d2, d3 = ops["alu"], ops["add2"], ops["add3"]
    x2 = min(d2, (alu + d2 + d3) / 2)
    if x2 < d2:
        return alu + d2 + d3 - x2, x2
    x3 = min(d3, max(0.0, (alu + d3 - d2) / 3))
    return alu + d3 - x3, d2 + 2 * x3


def sha_bound(ops: dict, nbytes_: int) -> dict:
    """The least time of a SHA-256 kernel's work: the operations these
    inputs need (sha_ops of sha_compression_ops, and the byte swaps) on the
    two integer pipes as pipe_split balances them (the issue bound), against
    its bytes at the memory rate."""
    alu_pipe, fma_pipe = pipe_split(ops)
    ops_ms = max(alu_pipe, fma_pipe) / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes_ / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "alu_pipe_ops": alu_pipe, "fma_pipe_ops": fma_pipe,
            "pipe_ops_per_s": INT32_OPS_PER_S, "ops_ms": ops_ms,
            "bytes": nbytes_, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def latency_floor(bd: dict, chain: int, probe: dict, mhz: float, ms: float) -> None:
    """Into a sha_bound: the latency floor of a chain of `chain` dependent
    compressions (64 rounds, each at least one SHF.R.W -> LOP3 -> IADD3
    deep, at the probe's latencies and the card's maximum SM clock), and
    the kernel's share of the larger of it and the issue bound."""
    per_round = probe["round_depth_cycles"]
    bd["latency_floor_ms"] = chain * 64 * per_round / (mhz * 1e3)
    bd["latency_floor_chain"] = chain
    bd["latency_floor_cycles_per_round"] = per_round
    bd["floor_ms"] = max(bd["bound_ms"], bd["latency_floor_ms"])
    bd["floor_by"] = ("latency" if bd["latency_floor_ms"] >= bd["bound_ms"]
                      else bd["bound_by"])
    bd["floor_share"] = bd["floor_ms"] / ms


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


#: csrc/probe/sha_probe.cu's chain kinds: latency of one dependent
#: instruction, then one lone warp's cycles per instruction over 8 chains
SHA_LATENCY_KINDS = ("shf", "lop3", "iadd3", "imad", "round")
SHA_ISSUE_KINDS = ("shf", "lop3", "iadd3", "imad", "iadd3_imad")
SHA_PROBE_STEPS = 4096


def _sha_probe_fn(name: str, argtypes: list):
    import ctypes

    from firedancer_tpu_torch.utils import kbuild

    fn = getattr(kbuild.load("probe/sha_probe"), name)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + argtypes
    fn.restype = ctypes.c_int
    return fn


def sha_op_probe(dev) -> dict:
    """Cycles of the round's instructions on one warp (clock64, chains of
    SHA_PROBE_STEPS): each kind's dependent latency, the round's SHF.R.W ->
    LOP3 -> IADD3 step, and a lone warp's cycles per instruction over 8
    independent chains.  round_depth_cycles, the latency floor's cycles a
    round, is the sum of the three latencies."""
    import ctypes

    import torch

    fn = _sha_probe_fn("fdt_probe_sha_op_launch",
                       [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rng = np.random.default_rng(2034)
    inp = rng.integers(0, 1 << 32, 49, dtype=np.uint64).astype(np.uint32)
    inp[16] = 7
    src = torch.from_numpy(inp.view(np.int32)).to(dev)
    out = torch.empty(32, dtype=torch.int32, device=dev)
    cyc = torch.empty(32, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n = SHA_PROBE_STEPS

    def run(kind, threads=32):
        cyc.zero_()
        for _ in range(2):  # warm, then measured
            if fn(kind, src.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, threads, stream):
                raise RuntimeError("sha probe launch failed")
        sync()
        return int(cyc.max())

    lat = {k: run(i) / n for i, k in enumerate(SHA_LATENCY_KINDS)}
    issue = {k: run(5 + i) / (8 * n) for i, k in enumerate(SHA_ISSUE_KINDS)}
    half = {k: run(5 + i, 16) / (8 * n) for i, k in enumerate(SHA_ISSUE_KINDS)}
    return {"latency_cycles": lat, "issue_cycles_per_instruction": issue,
            "issue_cycles_per_instruction_16_threads": half,
            "round_depth_cycles": lat["shf"] + lat["lop3"] + lat["iadd3"],
            "steps": n}


#: csrc/probe/sha_probe.cu's PoH variants, by `which`
POH_PROBE_VARIANTS = ("old", "one_warp", "one_warp_fma_adds", "new", "round_warp_alone")


def poh_probe(dev, n: int, order=(0, 3, 1, 2, 4, 4, 2, 1, 3, 0)) -> dict:
    """Cycles of one dependent compression of 32 lanes (n PoH appends each,
    clock64), csrc/probe/sha_probe.cu's variants in turns: the compression
    before its redesign ("old"), sha256.cuh's on one warp, the same with
    every add on IMAD, fdt_poh_chain's two warps ("new"), and its round
    warp alone without the hand-over (what the barriers cost); every
    lane's end state but the last variant's held against hashlib."""
    import ctypes

    import torch

    fn = _sha_probe_fn("fdt_probe_poh_launch", [ctypes.c_int, ctypes.c_void_p])
    rng = np.random.default_rng(2035)
    starts = rng.integers(0, 256, (32, 32), np.uint8)
    want = []
    for i in range(32):
        st = starts[i].tobytes()
        for _ in range(n):
            st = hashlib.sha256(st).digest()
        want.append(st)
    words = starts.reshape(32, 8, 4)[..., ::-1].copy().view(np.uint32).reshape(32, 8)
    src = torch.from_numpy(words.view(np.int32)).to(dev)
    out = torch.empty((32, 8), dtype=torch.int32, device=dev)
    cyc = torch.empty(32, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    runs = []
    for which in order:
        if fn(which, src.data_ptr(), out.data_ptr(), cyc.data_ptr(), n, stream):
            raise RuntimeError("poh probe launch failed")
        sync()
        got = out.cpu().numpy().view(np.uint32).reshape(32, 8, 1).view(np.uint8)
        got = got.reshape(32, 8, 4)[..., ::-1].reshape(32, 32)
        if (POH_PROBE_VARIANTS[which] != "round_warp_alone"
                and [got[i].tobytes() for i in range(32)] != want):
            raise AssertionError(f"poh probe {POH_PROBE_VARIANTS[which]} differs from hashlib")
        runs.append(int(cyc.max()) / n)
    out_ = {"order": [POH_PROBE_VARIANTS[w] for w in order], "cycles_per_compression": runs}
    for w in sorted(set(order)):
        out_[POH_PROBE_VARIANTS[w]] = statistics.median(
            [r for v, r in zip(order, runs) if v == w])
    return {**out_, "appends": n, "matches_hashlib": True}


def launch_ms(call, n: int) -> float:
    """Device ms of one raw launch: n launches of call(stream) (a C launch
    on the current stream, no wrapper) between two CUDA events, after one
    warm-up, divided by n."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    if call(stream):
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        call(stream)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def profiled_kernels(fn, calls: int = 10, tries: int = 8) -> dict:
    """The device kernels of `calls` fn() calls by name, from torch.profiler
    (copies and fills counted apart, as "_copies"), with "_calls" and the
    profiles it took ("_tries"); raises where `tries` profiles in a row
    showed no device event.  The profiler may miss an event of a short
    kernel, never add one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for tried in range(1, tries + 1):
        out = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = "_copies" if e.name.startswith(("Memcpy", "Memset")) else e.name
            out[name] = out.get(name, 0) + 1
        if out:
            return {**out, "_calls": calls, "_tries": tried}
    raise AssertionError(f"torch.profiler saw no device event in {tries} profiles")


def check_one_kernel(kernels: dict, prefix: str, what: str) -> None:
    """The profiled calls ran one kernel, named `prefix`..., once a call
    (the profiler may have missed one of its events) and no other."""
    names = {k: v for k, v in kernels.items() if not k.startswith("_")}
    calls = kernels["_calls"]
    if (len(names) != 1 or not next(iter(names)).startswith(prefix)
            or not calls - 1 <= next(iter(names.values())) <= calls):
        raise AssertionError(f"{what} ran {names} in {calls} calls, "
                             f"not one {prefix} launch a call")


def poh_slot(seed: int):
    """One slot built on the host with hashlib: SLOT_TICKS tick intervals of
    HASHES_PER_TICK hashes, each ENTRIES_PER_TICK - 1 mixin entries (hash
    counts cut at seeded points) and one tick entry that completes the
    interval.  -> starts, hashcnts, mixins, has_mixin, ends (numpy)."""
    rng = np.random.default_rng(seed)
    per = ENTRIES_PER_TICK
    n = SLOT_TICKS * per
    mixins = rng.integers(0, 256, (n, 32), np.uint8)
    has = np.tile(np.arange(per) < per - 1, SLOT_TICKS)
    hashcnts = np.zeros(n, np.int32)
    for t in range(SLOT_TICKS):
        cuts = np.sort(rng.choice(np.arange(1, HASHES_PER_TICK), per - 1, replace=False))
        hashcnts[t * per:(t + 1) * per] = np.diff(
            np.concatenate([[0], cuts, [HASHES_PER_TICK]]))
    starts = np.zeros((n, 32), np.uint8)
    ends = np.zeros((n, 32), np.uint8)
    st = rng.bytes(32)
    sha = hashlib.sha256
    for i in range(n):
        starts[i] = np.frombuffer(st, np.uint8)
        for _ in range(int(hashcnts[i]) - int(has[i])):
            st = sha(st).digest()
        if has[i]:
            st = sha(st + mixins[i].tobytes()).digest()
        ends[i] = np.frombuffer(st, np.uint8)
    return starts, hashcnts, mixins, has, ends


#: the operations of the compressions of the two kernels' lanes
#: (sha_compression_ops): a PoH append (the state's padding half constant,
#: from the initial state), a first message block, a later one, the mixin's
#: padding block (its whole message constant)
SHA_FIRST_BLOCK_OPS = sha_compression_ops(const_state=True)
SHA_BLOCK_OPS = sha_compression_ops()
POH_APPEND_OPS = sha_compression_ops(range(8, 16), const_state=True)
POH_PAD_BLOCK_OPS = sha_compression_ops(range(16))
#: byte swaps (PRMT, ALU pipe) of 32 bytes and of a 64-byte block
SWAP32_OPS, SWAP64_OPS = {"alu": 8}, {"alu": 16}


def phase_poh(dev, put, probe: dict) -> dict:
    """The PoH path (verify_entries over one slot, launch count from 0, its
    device kernels profiled), the kernel against its plain version, times
    (the raw launch and the entry point), the floors and the old and new
    compressions' cycles; -> the kernel's row of the kernels line."""
    import torch

    from firedancer_tpu_torch.ops import poh as POH
    from firedancer_tpu_torch.ops import sha256 as SHA

    t0 = time.time()
    starts, hcs, mixins, has, ends = poh_slot(2029)
    host_s = time.time() - t0
    SHA.LAUNCHES["poh_chain"] = 0
    got = POH.verify_entries(starts, hcs, mixins, has, HASHES_PER_TICK, device=dev)
    sync()
    launches = SHA.LAUNCHES["poh_chain"]
    got = got.cpu().numpy()
    if not np.array_equal(got, ends) or not np.array_equal(got[:-1], starts[1:]):
        raise AssertionError("verify_entries differs from the host chain")
    if launches != 1:
        raise AssertionError(f"verify_entries launched fdt_poh_chain {launches} times")
    kernels = profiled_kernels(lambda: POH.verify_entries(
        starts, hcs, mixins, has, HASHES_PER_TICK, device=dev))
    check_one_kernel(kernels, "fdt_poh_chain", "verify_entries")

    # one lane appended HASHES_PER_TICK times: hashlib, and the time of one
    # dependent compression (the self-measured chain floor)
    ref = starts[0].tobytes()
    for _ in range(HASHES_PER_TICK):
        ref = hashlib.sha256(ref).digest()
    if POH.append_n(starts[:1], HASHES_PER_TICK, device=dev).cpu().numpy()[0].tobytes() != ref:
        raise AssertionError("append_n differs from hashlib")
    st_d, mx_d, has_d, hc_d = put(starts), put(mixins), put(has), put(hcs)
    one = (st_d[:1], torch.full((1,), HASHES_PER_TICK, dtype=torch.int32, device=dev),
           mx_d[:1], torch.zeros(1, dtype=torch.bool, device=dev))
    one_ms = cuda_ms(lambda: SHA.poh_chain_bytes(*one), reps=5)
    ns_per = one_ms * 1e6 / HASHES_PER_TICK

    # the kernel against its plain version on every lane at POH_PLAIN_MAX
    small = put(hcs % (POH_PLAIN_MAX + 1))
    n_small = torch.where(has_d, small - 1, small)
    ker = SHA.poh_chain_bytes(st_d, n_small, mx_d, has_d)
    plain = SHA.poh_chain_bytes_plain(st_d, n_small, mx_d, has_d)
    sync()
    err = bytes_max_err(ker, plain)
    if err != 0:
        raise AssertionError("poh_chain_bytes disagrees with poh_chain_bytes_plain")

    n_full = torch.where(has_d, hc_d - 1, hc_d)
    args = SHA.poh_args(st_d, n_full, mx_d, has_d)
    ms = {
        "poh_chain": launch_ms(lambda stream: SHA.poh_call(*args, stream), 10),
        "poh_chain_one_call": cuda_ms(lambda: SHA.poh_chain_bytes(st_d, n_full, mx_d, has_d),
                                      reps=5),
        "verify_entries": cuda_ms(lambda: POH.verify_entries(
            starts, hcs, mixins, has, HASHES_PER_TICK, device=dev), reps=3),
        "poh_chain_at_plain_size": cuda_ms(
            lambda: SHA.poh_chain_bytes(st_d, n_small, mx_d, has_d), reps=5),
        "poh_chain_plain_at_plain_size": cuda_ms(
            lambda: SHA.poh_chain_bytes_plain(st_d, n_small, mx_d, has_d), reps=1, warmup=0),
        "one_lane_chain": one_ms,
    }
    lane_comps = n_full.clamp(min=0) + 2 * has_d.to(torch.int32)
    chain = int(lane_comps.max())
    mixes = int(has_d.sum())
    ops = sha_ops((int(n_full.clamp(min=0).sum()), POH_APPEND_OPS),
                  (mixes, SHA_FIRST_BLOCK_OPS), (mixes, POH_PAD_BLOCK_OPS),
                  (2 * len(hcs) + mixes, SWAP32_OPS))
    bd = sha_bound(ops, len(hcs) * (32 + 4 + 32 + 1 + 32))
    bd["compressions"] = int(lane_comps.sum())
    mhz = max_sm_clock_mhz()
    bd["chain_floor_ms"] = chain * ns_per * 1e-6
    bd["bound_share"] = bd["bound_ms"] / ms["poh_chain"]
    bd["chain_floor_share"] = bd["chain_floor_ms"] / ms["poh_chain"]
    latency_floor(bd, chain, probe, mhz, ms["poh_chain"])
    turns = poh_probe(dev, SHA_PROBE_STEPS)
    emit({"phase": "poh", "entries": len(hcs), "hashes": int(hcs.sum()),
          "max_hashcnt": HASHES_PER_TICK, "host_chain_seconds": host_s,
          "end_states_match_host_chain": True, "linked": True,
          "append_n_matches_hashlib": True, "poh_chain_launches": launches,
          "verify_entries_kernels_profiled": kernels,
          "kernel_vs_plain": {"max_hashcnt": POH_PLAIN_MAX, "lanes": len(hcs),
                              "max_abs_err": err},
          "ms": ms, "ns_per_dependent_compression": ns_per,
          "cycles_per_dependent_compression_at_max_sm_clock": ns_per * mhz / 1e3,
          "probe_cycles_per_dependent_compression": turns,
          "max_sm_clock_mhz": mhz, "hashes_per_s": int(hcs.sum()) / ms["poh_chain"] * 1e3,
          "bound": bd, "card": nvidia_smi_line()})
    return {"name": "poh_chain", "route": "cuda",
            "source": "firedancer_tpu_torch/csrc/sha256.cu",
            "replaces": "firedancer_tpu/ops/poh.py:54", "launches": launches,
            "max_abs_err": err, "ms": ms["poh_chain"],
            "plain_ms": ms["poh_chain_plain_at_plain_size"],
            "plain_at": f"max_hashcnt {POH_PLAIN_MAX}, all lanes",
            "ms_at_plain_size": ms["poh_chain_at_plain_size"],
            "entry_ms": ms["verify_entries"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"], "library_ms": None,
            "latency_floor_ms": bd["latency_floor_ms"],
            "chain_floor_ms": bd["chain_floor_ms"], "ns_per_compression": ns_per}


def phase_sha256(dev, put, bt, probe: dict, ns_per: float) -> dict:
    """sha256 over the corpus's messages (launch count from 0, its device
    kernels profiled), the word forms, the kernel against its plain version,
    times (the raw launch and the entry point) and the raw launch at two
    widths whose rows start at every offset in a 16-byte granule; -> the
    kernel's row of the kernels line."""
    import torch

    from firedancer_tpu_torch.ops import sha256 as SHA

    msgs, lens = bt["msgs"], bt["lens"]
    n = len(lens)
    SHA.LAUNCHES["sha256_blocks"] = 0
    got = SHA.sha256(msgs, lens, device=dev)
    sync()
    launches = SHA.LAUNCHES["sha256_blocks"]
    got = got.cpu().numpy()
    if [got[i].tobytes() for i in range(n)] != [
            hashlib.sha256(msgs[i, : lens[i]].tobytes()).digest() for i in range(n)]:
        raise AssertionError("sha256 differs from hashlib")
    if launches != 1:
        raise AssertionError(f"sha256 launched fdt_sha256_blocks {launches} times")
    msgs_d, lens_d = put(msgs), put(lens.astype(np.int64))
    kernels = profiled_kernels(lambda: SHA.sha256(msgs_d, lens_d, device=dev))
    check_one_kernel(kernels, "fdt_sha256_blocks", "sha256")
    emit({"phase": "sha256_profile", "lanes": n, "width": msgs.shape[1],
          "sha256_kernels_profiled": kernels})
    rng = np.random.default_rng(2028)
    for width, fn in ((32, SHA.sha256_words32), (64, SHA.sha256_words64)):
        b = rng.integers(0, 256, (n, width), np.uint8)
        out = SHA.bytes_from_words(fn(SHA.words_from_bytes(put(b)), device=dev)).cpu().numpy()
        if any(out[i].tobytes() != hashlib.sha256(b[i].tobytes()).digest() for i in range(n)):
            raise AssertionError(f"sha256_words{width} differs from hashlib")

    ker = SHA.sha256_bytes(msgs_d, lens_d)
    plain = SHA.sha256_bytes_plain(msgs_d, lens_d)
    sync()
    err = bytes_max_err(ker, plain)
    if err != 0:
        raise AssertionError("sha256_bytes disagrees with sha256_bytes_plain")
    args = SHA.sha256_args(msgs_d, lens_d)
    ms = {
        "sha256_blocks": launch_ms(lambda stream: SHA.sha256_call(*args, stream), 200),
        "sha256_blocks_one_call": cuda_ms(lambda: SHA.sha256_bytes(msgs_d, lens_d), reps=20),
        "sha256_bytes_plain": cuda_ms(
            lambda: SHA.sha256_bytes_plain(msgs_d, lens_d), reps=1, warmup=0),
        "sha256": cuda_ms(lambda: SHA.sha256(msgs_d, lens_d, device=dev), reps=20),
        "sha256_from_numpy": cuda_ms(lambda: SHA.sha256(msgs, lens, device=dev), reps=5),
    }
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        SHA.sha256(msgs_d, lens_d, device=dev)
    sync()
    ms["sha256_back_to_back"] = (time.perf_counter() - t0) * 1e3 / 200  # host clock
    # a Merkle layer's rows (ballet/bmtree: a 1-byte prefix and two 32-byte
    # nodes, in a 66-byte row) and an odd message width, every lane against
    # hashlib
    odd = {}
    for width, wl in ((66, 65 + np.arange(n) % 2), (1231, np.minimum(lens, 1231))):
        wm = np.ascontiguousarray(msgs[:, :width])
        wm_d, wl_d = put(wm), put(wl.astype(np.int64))
        out = SHA.sha256_bytes(wm_d, wl_d).cpu().numpy()
        if [out[i].tobytes() for i in range(n)] != [
                hashlib.sha256(wm[i, : wl[i]].tobytes()).digest() for i in range(n)]:
            raise AssertionError(f"sha256_bytes at width {width} differs from hashlib")
        wargs = SHA.sha256_args(wm_d, wl_d)
        odd[width] = {"blocks": int(((wl + 9 + 63) // 64).sum()),
                      "ms": launch_ms(lambda stream: SHA.sha256_call(*wargs, stream), 200)}
    nblocks = (lens_d + 9 + 63) // 64
    total = int(nblocks.sum())
    ops = sha_ops((n, SHA_FIRST_BLOCK_OPS), (total - n, SHA_BLOCK_OPS),
                  (total, SWAP64_OPS), (n, SWAP32_OPS))
    bd = sha_bound(ops, n * msgs.shape[1] + n * (8 + 32))
    bd["compressions"] = total
    bd["chain_floor_ms"] = int(nblocks.max()) * ns_per * 1e-6
    bd["bound_share"] = bd["bound_ms"] / ms["sha256_blocks"]
    latency_floor(bd, int(nblocks.max()), probe, max_sm_clock_mhz(), ms["sha256_blocks"])
    emit({"phase": "sha256", "lanes": n, "width": msgs.shape[1],
          "all_lanes_match_hashlib": True, "words32_words64_lanes": n,
          "sha256_blocks_launches": launches, "max_abs_err": err, "ms": ms,
          "kernel_at_widths": odd,
          "digests_per_s": n / ms["sha256"] * 1e3, "bound": bd, "card": nvidia_smi_line()})
    return {"name": "sha256_blocks", "route": "cuda",
            "source": "firedancer_tpu_torch/csrc/sha256.cu",
            "replaces": "firedancer_tpu/ops/sha256.py:49", "launches": launches,
            "max_abs_err": err, "ms": ms["sha256_blocks"],
            "plain_ms": ms["sha256_bytes_plain"], "entry_ms": ms["sha256"],
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"], "library_ms": None,
            "latency_floor_ms": bd["latency_floor_ms"],
            "chain_floor_ms": bd["chain_floor_ms"]}


def phase_reedsol(dev, put) -> None:
    """FEC_SETS full 32:32 sets side by side: encode against _encode_host,
    recovery from three seeded 32-row losses, and 31 survivors."""
    from firedancer_tpu_torch.ops import reedsol as RS

    rng = np.random.default_rng(2030)
    n = FEC_SETS * FEC_WIDTH
    total = 2 * FEC_DATA
    data = rng.integers(0, 256, (FEC_DATA, n), np.uint8)
    t0 = time.time()
    want = RS._encode_host(data, FEC_DATA)
    host_s = time.time() - t0
    data_d = put(data)
    if not np.array_equal(RS.encode(data_d, FEC_DATA, device=dev).cpu().numpy(), want):
        raise AssertionError("encode differs from _encode_host")
    shreds = np.concatenate([data, want])
    patterns = {}
    for name in ("random_a", "random_b", "parity_only"):
        present = np.ones(total, bool)
        lost = (np.arange(FEC_DATA) if name == "parity_only"
                else rng.choice(total, FEC_DATA, replace=False))
        present[lost] = False
        patterns[name] = present
        garbage = shreds.copy()
        garbage[~present] = 0xA5
        got = RS.recover(put(garbage), present, FEC_DATA, device=dev)
        if got is None or not np.array_equal(got.cpu().numpy(), data):
            raise AssertionError(f"recover ({name}) does not give back the data")
    partial = np.zeros(total, bool)
    partial[rng.choice(total, FEC_DATA - 1, replace=False)] = True
    shreds_d = put(shreds)
    if RS.recover(shreds_d, partial, FEC_DATA, device=dev) is not None:
        raise AssertionError("recover with 31 survivors did not return None")
    ms = {"encode": cuda_ms(lambda: RS.encode(data_d, FEC_DATA, device=dev), reps=5),
          "recover": cuda_ms(lambda: RS.recover(
              shreds_d, patterns["parity_only"], FEC_DATA, device=dev), reps=3)}
    emit({"phase": "reedsol", "fec_sets": FEC_SETS, "data_shreds": FEC_SETS * FEC_DATA,
          "coded_width": FEC_WIDTH, "encode_matches_host": True,
          "recovered": sorted(patterns), "partial_returns_none": True,
          "host_encode_seconds": host_s, "ms": ms,
          "encode_data_bytes_per_s": data.nbytes / ms["encode"] * 1e3,
          "matmul_dtype": str(RS.MATMUL_DTYPE), "card": nvidia_smi_line()})


def phase_sign(dev, bt) -> None:
    """sign_many over B distinct keys and messages, every signature held
    against golden.sign (in a pool of host processes)."""
    from firedancer_tpu_torch.ops.ed25519 import sign as SIGN

    rng = np.random.default_rng(2031)
    n = len(bt["lens"])
    pairs = [(rng.bytes(32), bt["msgs"][i, : bt["lens"][i]].tobytes()) for i in range(n)]
    sync()
    t0 = time.time()
    sigs = SIGN.sign_many(pairs, device=dev)
    sign_s = time.time() - t0
    # the device step alone, on n canonical scalars (the signatures' S)
    scalars = torch_from(np.stack([np.frombuffer(s[32:], np.uint8) for s in sigs]), dev)
    base_ms = cuda_ms(lambda: SIGN._base_mul_compress(scalars), reps=1)
    procs = min(8, os.cpu_count() or 1)
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        parts = pool.map(_golden_sign_chunk, [pairs[i::procs] for i in range(procs)])
    golden_s = time.time() - t0
    want = [None] * n
    for i, part in enumerate(parts):
        want[i::procs] = part
    if sigs != want:
        raise AssertionError("sign_many differs from golden.sign")
    emit({"phase": "sign", "lanes": n, "distinct_keys": len({p[0] for p in pairs}),
          "all_match_golden": True, "sign_many_seconds": sign_s,
          "signs_per_s": n / sign_s, "base_mul_compress_ms": base_ms,
          "golden_seconds": golden_s, "golden_processes": procs,
          "card": nvidia_smi_line()})


def torch_from(a, dev):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def phase_keccak_blake3(dev, put, bt) -> None:
    """keccak256 and blake3 of B messages on the card, CHECK_LANES seeded
    lanes held against digest_host and the CPU run; BLAKE3's empty input."""
    from firedancer_tpu_torch.ops import blake3 as B3
    from firedancer_tpu_torch.ops import keccak256 as KK

    msgs, lens = bt["msgs"], bt["lens"]
    n = len(lens)
    lanes = np.random.default_rng(2032).choice(n, CHECK_LANES, replace=False)
    msgs_d, lens_d = put(msgs), put(lens.astype(np.int64))
    k = KK.keccak256(msgs_d, lens_d, device=dev).cpu().numpy()
    for i in lanes:
        if k[i].tobytes() != KK.digest_host(msgs[i, : lens[i]].tobytes()):
            raise AssertionError(f"keccak256 lane {i} differs from digest_host")
    rng = np.random.default_rng(2033)
    bl = rng.integers(0, B3.CHUNK_LEN + 1, n)
    bl[:2] = [0, B3.CHUNK_LEN]
    bm = msgs[:, : B3.CHUNK_LEN].copy()
    bm[np.arange(B3.CHUNK_LEN)[None, :] >= bl[:, None]] = 0
    bm_d, bl_d = put(bm), put(bl)
    b3 = B3.blake3(bm_d, bl_d, device=dev).cpu().numpy()
    if b3[0].tobytes().hex() != BLAKE3_EMPTY:
        raise AssertionError("blake3 of the empty input differs from the published digest")
    if not np.array_equal(b3[lanes], B3.blake3(bm[lanes], bl[lanes], device="cpu").numpy()):
        raise AssertionError("blake3 on the card differs from the CPU run")
    ms = {"keccak256": cuda_ms(lambda: KK.keccak256(msgs_d, lens_d, device=dev), reps=3),
          "blake3": cuda_ms(lambda: B3.blake3(bm_d, bl_d, device=dev), reps=3)}
    emit({"phase": "keccak_blake3", "lanes": n, "keccak_width": msgs.shape[1],
          "blake3_width": B3.CHUNK_LEN, "lanes_checked": CHECK_LANES,
          "keccak_matches_digest_host": True, "blake3_matches_cpu": True,
          "blake3_empty_vector": True, "ms": ms,
          "hashes_per_s": {name: n / t * 1e3 for name, t in ms.items()},
          "card": nvidia_smi_line()})


def run_rest(dev, batches) -> list:
    """The phases of the rest of ops/; -> the kernels line's rows of the two
    SHA-256 kernels."""
    from firedancer_tpu_torch.utils import kbuild

    put = lambda a: torch_from(a, dev)  # noqa: E731
    sass = kbuild.sass("sha256")
    per = {k: loop_profile(sass, k) for k in ("fdt_sha256_blocks", "fdt_poh_chain")}
    probe = sha_op_probe(dev)
    emit({"phase": "sha256_sass", "compression_loops": per, "probe": probe,
          "probe_loops": all_loop_counts(kbuild.sass("probe/sha_probe"), "fdt_probe_sha_op")})
    poh_row = phase_poh(dev, put, probe)
    sha_row = phase_sha256(dev, put, batches[0], probe, poh_row.pop("ns_per_compression"))
    phase_reedsol(dev, put)
    phase_sign(dev, batches[1])
    phase_keccak_blake3(dev, put, batches[0])
    return [sha_row, poh_row]


# ---------------------------------------------------------------------------
# the multi-device layer: the dp x mp step, the verify pool, bench, configure
# ---------------------------------------------------------------------------

#: lanes of the pool's fault-injected run (the host strict path verifies
#: them, a few ms a lane)
POOL_FAULT_LANES = 64


def free_port() -> int:
    """A free TCP port on localhost for the process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist_step(dev, batches, single_bloom, keeps, metrics) -> None:
    """The step as one rank of an NCCL group of one (dp = mp = 1) on the
    corpus batches, held against the single-card step's keep, metrics and
    filter (`keeps`, `metrics`, `single_bloom` from the slice phase); batch 1
    run twice on the same buffers (C-1: a pool's resubmit); the ms per step
    beside the single-card step, and the cost of the step's fresh filter
    copy.  NCCL must come up: there is no fallback to gloo or the CPU."""
    import torch
    import torch.distributed as dist

    from firedancer_tpu_torch.models import pipeline as PL
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.parallel.mesh import init_mesh

    t0 = time.time()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        backend = dist.get_backend()
        mesh = init_mesh(1, 1)
        step = PL.make_step(dev, mesh)
        bloom = PL.AgingBloom(dev, capacity=B)  # one batch: forces a rotation
        VC.LAUNCHES = 0
        got_keeps, got_metrics, twice = [], [], None
        for i, bt in enumerate(batches):
            args = [bt[k] for k in ("msgs", "lens", "sigs", "pubs", "tags2")]
            keep, cur, met = step(*args, *bloom.buffers())
            if i == 1:
                keep2, cur2, met2 = step(*args, *bloom.buffers())
                twice = (bool(torch.equal(keep, keep2)), bool(torch.equal(met, met2)),
                         bool(torch.equal(cur, cur2)))
            bloom.update(cur, met)
            got_keeps.append(keep.cpu().numpy())
            got_metrics.append(met.cpu().numpy().tolist())
        sync()
        launches = VC.LAUNCHES
        for i in range(len(batches)):
            if not np.array_equal(got_keeps[i], keeps[i]) or got_metrics[i] != metrics[i]:
                raise AssertionError(f"dist step {i}: keep/metrics differ from the "
                                     f"single-card step ({got_metrics[i]} vs {metrics[i]})")
        if twice != (True, True, True):
            raise AssertionError(f"a batch run twice on the same buffers differs: {twice}")
        filter_equal = all(bool(torch.equal(a, b)) for a, b in
                           zip(bloom.buffers(), single_bloom.buffers()))
        if not filter_equal or (bloom.inserted, bloom.rotations) != (
                single_bloom.inserted, single_bloom.rotations) or bloom.rotations < 1:
            raise AssertionError("the dist step's filter differs from the single-card "
                                 f"step's (rotations {bloom.rotations})")
        if launches < len(batches) + 1:
            raise AssertionError(f"verify_core launched {launches} times")

        bt = batches[2]
        t = {k: torch_from(bt[k], dev) for k in ("msgs", "sigs", "pubs")}
        lens_d = torch_from(bt["lens"].astype(np.int64), dev)
        tags_d = torch_from(bt["tags2"].astype(np.int64), dev)
        single = PL.make_step(dev)
        cur_d, prev_d = PL.fresh_bloom(dev), PL.fresh_bloom(dev)
        ins = (t["msgs"], lens_d, t["sigs"], t["pubs"], tags_d, cur_d, prev_d)
        ms = {}
        for name in ("single", "dist", "dist", "single"):  # in turns
            fn = single if name == "single" else step
            ms.setdefault(name, []).append(cuda_ms(lambda: fn(*ins), reps=2, warmup=0))
        ms = {f"step_{k}": statistics.median(v) for k, v in ms.items()}
        ms["fresh_filter_copy"] = cuda_ms(lambda: cur_d.clone(), reps=20)
        ok_d = torch.ones(B, dtype=torch.bool, device=dev)
        ms["dedup_single"] = cuda_ms(lambda: PL.dedup(ok_d, tags_d, cur_d, prev_d), reps=5)
        ms["dedup_dist"] = cuda_ms(
            lambda: PL.dedup(ok_d, tags_d, cur_d, prev_d, mesh), reps=5)
    finally:
        dist.destroy_process_group()
    emit({"phase": "dist_step", "backend": backend, "dp": 1, "mp": 1, "lanes": B,
          "steps": len(batches), "metrics": got_metrics, "rotations": bloom.rotations,
          "matches_single_card": True, "filter_words_equal": filter_equal,
          "run_twice_same_answer": True, "verify_core_launches": launches,
          "filter_copy_bytes": cur_d.numel() * 4, "ms": ms, "card": nvidia_smi_line(),
          "seconds": time.time() - t0})


def phase_pool(dev, batches) -> None:
    """run_verify_pool over local_device_count() CUDA domains on eight corpus
    batches (the four, twice) in the digest form: in-order landing, every
    verdict equal to a direct verify_batch_digest, one verify_core launch per
    batch, no fallback and no device error; then a fault-injected run at
    small B whose only domain raises on its first dispatch: quarantined, and
    the pool raises DomainsOut instead of landing the card's batches on the
    host."""
    from firedancer_tpu_torch.ops.ed25519 import verify as V
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.parallel import dryrun
    from firedancer_tpu_torch.tiles import verify as T
    from firedancer_tpu_torch.utils.devices import local_device_count

    t0 = time.time()
    n_dom = local_device_count()
    inputs = [(digests_of(bt), bt["sigs"], bt["pubs"]) for bt in batches]
    direct = [V.verify_batch_digest(*b, device=dev).cpu().numpy() for b in inputs]
    pool_batches = inputs * 2
    fns = dryrun.domain_fns(n_dom, dev, inputs[0])  # warmed: not counted
    sync()
    VC.LAUNCHES = 0
    rep = dryrun.run_verify_pool(n_dom, device=dev, batches=pool_batches, fns=fns)
    sync()
    launches = VC.LAUNCHES
    for i, ok in enumerate(rep["verdicts"]):
        if not np.array_equal(ok, direct[i % len(inputs)]) or not np.array_equal(
                ok, batches[i % len(inputs)]["ok"]):
            raise AssertionError(f"pool batch {i}: verdicts differ from the direct call")
    if rep["fallback_batches"] or rep["device_errors"]:
        raise AssertionError(f"pool degraded on healthy cards: {rep}")
    if launches != len(pool_batches):
        raise AssertionError(f"verify_core launched {launches} times for "
                             f"{len(pool_batches)} pool batches")

    def direct_call():
        V.verify_batch_digest(*inputs[0], device=dev).cpu()

    direct_ms = cuda_ms(direct_call, reps=5)

    small = [tuple(a[:POOL_FAULT_LANES] for a in b) for b in inputs]
    calls = []

    def first_dispatch_fails(index):
        calls.append(index)
        if len(calls) == 1:
            raise RuntimeError("injected device error")

    try:
        dryrun.run_verify_pool(1, device=dev, batches=small,
                               fault_hook=first_dispatch_fails, trip_after=1,
                               backoff_base_s=300.0, backoff_max_s=300.0)
    except T.DomainsOut as e:
        fault = e.counters
    else:
        raise AssertionError("the pool landed a quarantined card's batches")
    if (fault["device_errors"], fault["device_trips"]) != (1, 1) or \
            fault["fallback_batches"] != 0 or sum(fault["landed"]) != 0:
        raise AssertionError(f"fault run counters: {fault}")
    counters = ("landed", *T.POLICY_COUNTERS, "resubmits", "late_results")
    emit({"phase": "pool", "domains": n_dom, "lanes": B, "batches": len(pool_batches),
          "in_order": True, "verdicts_match_direct": True,
          "verify_core_launches": launches,
          "counters": {k: rep[k] for k in ("seconds", *counters)},
          "ms_per_batch_pool": rep["seconds"] * 1e3 / len(pool_batches),
          "ms_direct_call": direct_ms,
          "fault_injected": {"lanes": POOL_FAULT_LANES, "batches": len(small),
                             **{k: fault[k] for k in counters},
                             "quarantined": fault["device_trips"] == 1,
                             "raised": "DomainsOut"},
          "card": nvidia_smi_line(), "seconds": time.time() - t0})


#: the tiles phase: pool size, frags streamed, pool seed, the run loop's
#: idle sleeps (its default, and the 1 ms at which idle tile threads stop
#: starving the verify worker of the GIL)
TILES_POOL, TILES_FRAGS, TILES_SEED = 512, 65536, 5
TILES_IDLE_S = (50e-6, 1e-3)


def stamps_summary(stamps, seconds: float) -> dict:
    """The pool's dispatch/land stamps (µs, u32) of every landed batch ->
    the median dispatch-to-land time, the median time between landings, and
    the share of the run's wall time in which at least one batch was
    between dispatch and land (the host's view of a busy card)."""
    from firedancer_tpu_torch.disco.mux import ts_diff

    t0 = stamps[0][3]
    ivs = sorted((ts_diff(d, t0), ts_diff(l, t0)) for *_, d, l in stamps)
    busy, cur = 0, None
    for a, b in ivs:
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += cur[1] - cur[0]
    lands = sorted(b for _, b in ivs)
    return {
        "ms_dispatch_to_land_median": statistics.median(b - a for a, b in ivs) / 1e3,
        "ms_between_landings_median": (statistics.median(
            y - x for x, y in zip(lands, lands[1:])) / 1e3 if len(lands) > 1 else None),
        "inflight_share": busy / 1e6 / seconds,
    }


def check_tiles_front(r, launches: int) -> None:
    """The verify and dedup tiles' exact checks (tiles and leader phases)."""
    c = r["counters"]
    v = c["verify"]
    good = r["pool"]["good"]
    n_good, passes = int(good.sum()), TILES_FRAGS // TILES_POOL
    want = {
        ("verify", "in_frags"): TILES_FRAGS,
        ("verify", "verify_fail_txns"): (TILES_POOL - n_good) * passes,
        ("verify", "out_frags"): n_good * passes,
        ("verify", "device_batches"): TILES_FRAGS // B,
        ("verify", "fallback_batches"): 0,
        ("verify", "device_errors"): 0,
        ("verify", "device_trips"): 0,
        ("dedup", "dup_txns"): n_good * (passes - 1),
        ("dedup", "out_frags"): n_good,
    }
    got = {k: c[k[0]][k[1]] for k in want}
    if got != want:
        raise AssertionError(f"verify/dedup counters {got} != {want}")
    if launches != v["device_batches"] + 1:
        raise AssertionError(f"verify_core launched {launches} times for "
                             f"{v['device_batches']} batches and one warm-up")


def check_tiles(r, launches: int) -> None:
    """The tiles phase's exact checks; raises on any miss."""
    check_tiles_front(r, launches)
    c = r["counters"]
    v, d = c["verify"], c["dedup"]
    good = r["pool"]["good"]
    n_good = int(good.sum())
    if c["sink"]["sunk_frags"] != n_good:
        raise AssertionError(f"sink took {c['sink']['sunk_frags']} of {n_good}")
    if not np.array_equal(r["survivors"], r["pool"]["tags"][good]):
        raise AssertionError("sink survivors differ from the pool's good tags")
    if not (np.array_equal(r["payloads"], r["pool"]["rows"][good])
            and np.array_equal(r["sizes"], r["pool"]["szs"][good])):
        raise AssertionError("sink payloads differ from the pool's rows")
    if d["in_frags"] != v["out_frags"]:
        raise AssertionError(f"dedup took {d['in_frags']} of {v['out_frags']}")


def kernel_share(run) -> dict:
    """One tiles run under torch.profiler (CUDA activity only): the card's
    summed device time over the run's wall time.  The profile also holds
    the warm-up batch, one of the run's 17 equal batches of device work, so
    its share is taken out.  -> {"device_ms", "share"}, or {"not_measured":
    reason} when the profiler shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run()
    dev_us = sum(getattr(e, "self_device_time_total", 0) or 0
                 for e in prof.key_averages())
    if dev_us <= 0:
        return {"not_measured": "torch.profiler showed no device time"}, r
    batches = r["counters"]["verify"]["device_batches"]
    dev_us *= batches / (batches + 1)
    return {"device_ms": dev_us / 1e3, "share": dev_us / 1e6 / r["seconds"]}, r


def phase_tiles() -> None:
    """The ingress tile pipeline on the card through entry.ingress, at the
    verify tile's deployment size; see the module docstring."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.tiles.synth import make_txn_pool

    t0 = time.time()
    pool = make_txn_pool(TILES_POOL, corrupt_frac=0.1, seed=TILES_SEED)

    def run(idle_s):
        return entry.ingress(pool, total=TILES_FRAGS, max_lanes=B,
                             idle_sleep_s=idle_s)

    runs = []
    for idle_s in TILES_IDLE_S:
        sync()
        VC.LAUNCHES = 0
        r = run(idle_s)
        sync()
        launches = VC.LAUNCHES
        check_tiles(r, launches)
        runs.append({
            "idle_sleep_us": idle_s * 1e6, "txns_per_s": r["txns_per_s"],
            "seconds": r["seconds"], "e2e_p50_us": r["e2e_p50_us"],
            "e2e_p99_us": r["e2e_p99_us"], "verify_hop_p99_us": r["verify_hop_p99_us"],
            "device_batches": r["counters"]["verify"]["device_batches"],
            "verify_core_launches_after_warmup": launches - 1,
            **stamps_summary(r["landed_stamps"], r["seconds"])})
    share, r = kernel_share(lambda: run(TILES_IDLE_S[-1]))
    check_tiles(r, r["counters"]["verify"]["device_batches"] + 1)
    emit({"phase": "tiles", "pool": TILES_POOL, "frags": TILES_FRAGS, "lanes": B,
          "msg_width": W, "n_good": int(pool[2].sum()), "checks": "exact", "runs": runs,
          "kernel_time_share": {"idle_sleep_us": TILES_IDLE_S[-1] * 1e6,
                                "txns_per_s": r["txns_per_s"], **share},
          "card": nvidia_smi_line(), "seconds": time.time() - t0})
    return pool


#: the leader phase's runs: (pack device select, the run loop's idle sleep)
LEADER_RUNS = ((True, 50e-6), (True, 1e-3), (False, 1e-3))
#: recorded select calls held against the plain version after each run
LEADER_RECORDED = 3


def microblock_conflicts(txns) -> int:
    """Pairs in one microblock that write one account, or where one writes
    an account the other reads (counted per account)."""
    from firedancer_tpu_torch.ballet import txn as T

    writes, reads = [], []
    for t in txns:
        d = T.parse(t)
        writes += [bytes(d.acct_addr(t, j)) for j in d.writable_idxs()]
        reads += [bytes(d.acct_addr(t, j)) for j in d.readonly_idxs()]
    return len(writes) - len(set(writes)) + len(set(writes) & set(reads))


def check_leader(r, vc_launches: int) -> None:
    """The leader phase's exact checks; raises on any miss."""
    from firedancer_tpu_torch.tiles import wire

    check_tiles_front(r, vc_launches)
    c = r["counters"]
    good = r["pool"]["good"]
    n_good, banks = int(good.sum()), [k for k in c if k.startswith("bank")]
    p = c["pack"]
    got = {"inserted_txns": p["inserted_txns"], "insert_rejected": p["insert_rejected"],
           "executed_txns": sum(c[b]["executed_txns"] for b in banks),
           "fees_lamports": sum(c[b]["fees_lamports"] for b in banks),
           "malformed_microblocks": sum(c[b]["malformed_microblocks"] for b in banks)}
    want = {"inserted_txns": n_good, "insert_rejected": 0, "executed_txns": n_good,
            "fees_lamports": n_good * 5000, "malformed_microblocks": 0}
    if got != want or p["completions"] != p["microblocks"]:
        raise AssertionError(f"leader counters {got} != {want}, completions "
                             f"{p['completions']} of {p['microblocks']} microblocks")
    if any(r["pack_engine"].values()):
        raise AssertionError(f"pack engine not drained: {r['pack_engine']}")
    mbs = [m for per_sink in r["microblocks"] for m in per_sink]
    if len(mbs) != p["microblocks"]:
        raise AssertionError(f"sinks took {len(mbs)} of {p['microblocks']} microblocks")
    rows, szs = r["pool"]["rows"], r["pool"]["szs"]
    executed = sorted(t for _b, _h, txns in mbs for t in txns)
    if executed != sorted(rows[i, : szs[i] - wire.TRAILER_SZ].tobytes()
                          for i in np.flatnonzero(good)):
        raise AssertionError("the sinks' microblocks differ from the good pool's payloads")
    bad = [h for _b, h, txns in mbs if microblock_conflicts(txns)]
    if bad:
        raise AssertionError(f"microblocks {bad[:8]} hold conflicting txns")


def phase_leader(dev, pool) -> int:
    """The leader pipeline on the card through entry.leader (synth ->
    verify -> dedup -> pack -> bank x 2 -> sink x 2) at the verify tile's
    deployment size, three runs (LEADER_RUNS); -> pack_select's launches
    in the first run.  The hooks on the pack tile's thread only keep
    references and times (the engine's arrays are fresh for each call);
    every check runs after the run."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.ballet import pack as P
    from firedancer_tpu_torch.ops import pack_select as PS
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC

    t0 = time.time()
    PC = pack_cases_module()
    orig = PS.select_noconflict
    orig_sched, orig_spec = P.Pack.schedule_microblock, P.Pack._select_speculative
    runs, first_launches = [], None
    for select, idle_s in LEADER_RUNS:
        calls = []  # (args, take, the chain's steps, host ms)
        host_s = {"schedule": [], "speculative": []}

        def recording(*a, **kw):
            t = time.perf_counter()
            take = orig(*a, **kw)
            calls.append((a, take, kw["selector"].stats[0],
                          (time.perf_counter() - t) * 1e3))
            return take

        def timed(fn, key):
            def run(self, *a, **kw):
                t = time.perf_counter()
                out = fn(self, *a, **kw)
                host_s[key].append(time.perf_counter() - t)
                return out
            return run

        PS.select_noconflict = recording
        P.Pack.schedule_microblock = timed(orig_sched, "schedule")
        P.Pack._select_speculative = timed(orig_spec, "speculative")
        try:
            sync()
            VC.LAUNCHES = 0
            PS.LAUNCHES = 0
            r = entry.leader(pool, total=TILES_FRAGS, max_lanes=B, n_banks=2,
                             pack_device_select=select, idle_sleep_s=idle_s)
            sync()
            vc_launches, ps_launches = VC.LAUNCHES, PS.LAUNCHES
        finally:
            PS.select_noconflict = orig
            P.Pack.schedule_microblock = orig_sched
            P.Pack._select_speculative = orig_spec
        check_leader(r, vc_launches)
        if ps_launches != len(calls) or (select and not calls):
            raise AssertionError(f"pack_select launched {ps_launches} times for "
                                 f"{len(calls)} select calls (select {select})")
        over = sum(n > PC.step_bound(*a, take) for a, take, n, _ in calls)
        if over:
            raise AssertionError(f"{over} select calls took more chain steps than "
                                 "ceil(live / 32) + takes")
        # the first calls' inputs, again: kernel, plain on the card, host
        for a, take, _, _ in calls[:LEADER_RECORDED]:
            cu, tl = a[5], a[6]
            put = lambda x: torch_from(PS.split_u32(x), dev)  # noqa: E731
            args = [put(x) for x in a[:4]] + [torch_from(a[4].astype(np.int64), dev)]
            ker = PS.select_impl(*args, cu, tl).cpu().numpy()
            plain = PS.select_plain(*args, cu, tl).cpu().numpy()
            if not (np.array_equal(ker, take) and np.array_equal(plain, take)
                    and np.array_equal(host_greedy(*a[:5], cu, tl), take)):
                raise AssertionError("a recorded select differs from select_plain")
        if first_launches is None:
            first_launches = ps_launches
        c = r["counters"]
        mbs = c["pack"]["microblocks"]
        ms = [m for _, _, _, m in calls]
        steps = [n for _, _, n, _ in calls]
        runs.append({
            "pack_device_select": select, "idle_sleep_us": idle_s * 1e6,
            "txns_per_s": r["txns_per_s"], "executed_per_s": r["executed_per_s"],
            "seconds": r["seconds"], "front_seconds": r["front_seconds"],
            "microblocks": mbs, "blocks": c["pack"]["blocks"],
            "pack_loop_iters": c["pack"]["loop_iters"],
            "mean_txns_per_microblock": c["pack"]["microblock_txns"] / mbs,
            "microblocks_per_bank": [c[f"bank{i}"]["executed_microblocks"] for i in range(2)],
            **{k: v for k, v in r.items() if k.endswith("_us")},
            "verify_core_launches_after_warmup": vc_launches - 1,
            "select_calls": len(calls), "pack_select_launches": ps_launches,
            "select_seconds": sum(ms) / 1e3,
            "select_share_of_wall": sum(ms) / 1e3 / r["seconds"],
            "select_call_ms_median": statistics.median(ms) if ms else None,
            "select_call_ms_max": max(ms, default=None),
            "chain_steps_per_call": ({"median": statistics.median(steps),
                                      "max": max(steps)} if steps else None),
            # the pack engine's scheduling on the pack tile's thread: every
            # schedule call, and the device-select part (the ordered rows'
            # gather and padding, the select call, the pick order)
            "schedule_calls": len(host_s["schedule"]),
            "schedule_seconds": sum(host_s["schedule"]),
            "schedule_ms_median": (statistics.median(host_s["schedule"]) * 1e3
                                   if host_s["schedule"] else None),
            "speculative_seconds": sum(host_s["speculative"]),
            "recorded_selects_checked": min(len(calls), LEADER_RECORDED)})
    emit({"phase": "leader", "pool": TILES_POOL, "frags": TILES_FRAGS, "lanes": B,
          "msg_width": W, "n_good": int(pool[2].sum()), "banks": 2, "checks": "exact",
          "runs": runs, "card": nvidia_smi_line(), "seconds": time.time() - t0})
    return first_launches


#: the keys of bench.py's JSON line that the port's bench keeps
BENCH_KEYS = ("metric", "value", "unit", "n_devices", "per_device")
#: the keys of bench.py's pipeline results
PIPE_KEYS = ("verify_path_tps", "e2e_p50_us", "e2e_p99_us", "verify_hop_p99_us")


def phase_bench() -> None:
    """python -m firedancer_tpu_torch.bench in a subprocess: one parseable
    JSON line with bench.py's keys; then its pipeline mode, one line with
    bench.py's pipeline keys and no batch on the host."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", "firedancer_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bench exited {res.returncode}:\n{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench printed {len(lines)} lines")
    out = json.loads(lines[0])
    missing = [k for k in BENCH_KEYS if k not in out]
    if missing or out["metric"] != "ed25519_verifies_per_s_1chip" or out["value"] <= 0:
        raise AssertionError(f"bench line: missing {missing}, {out}")
    t1 = time.time()
    res = subprocess.run([sys.executable, "-m", "firedancer_tpu_torch.bench",
                          "--mode", "pipeline", "--idle-sleep-us", "1000"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"bench --mode pipeline exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    lines = res.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench --mode pipeline printed {len(lines)} lines")
    pipe = json.loads(lines[0])
    missing = [k for k in PIPE_KEYS if k not in pipe]
    if missing or pipe["value"] <= 0 or pipe["fallback_batches"]:
        raise AssertionError(f"bench --mode pipeline line: missing {missing}, {pipe}")
    emit({"phase": "bench", "line": out, "pipeline": pipe, "card": nvidia_smi_line(),
          "seconds": t1 - t0, "pipeline_seconds": time.time() - t1})


def phase_configure(t_start: float) -> None:
    """The port's device stage: it must report ok on the card."""
    from firedancer_tpu_torch.app import configure

    r = configure.stage_device()
    if not r.ok:
        raise AssertionError(f"configure device stage: {r.detail}")
    emit({"phase": "configure", "stage": r.name, "ok": r.ok, "detail": r.detail,
          "seconds_total": time.time() - t_start})


def run_multi(dev, batches, single_bloom, keeps, metrics, t_start) -> int:
    """The phases of the multi-device layer and the tile pipelines; ->
    pack_select's launches on the leader's first run."""
    phase_dist_step(dev, batches, single_bloom, keeps, metrics)
    phase_pool(dev, batches)
    pool = phase_tiles()
    launches = phase_leader(dev, pool)
    phase_bench()
    phase_configure(t_start)
    return launches


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
    put = lambda a: torch_from(a, dev)  # noqa: E731

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
    names = kbuild.build_all(kbuild.sources() + PROBES)
    build_s = time.time() - t0
    # the host ring library of the tile runtime (tango/native/, utils/cbuild.py)
    t0 = time.time()
    from firedancer_tpu_torch.tango import rings
    from firedancer_tpu_torch.utils import cbuild

    rings.trace_now()  # the first use builds and loads it
    ring_lib = {"library": os.path.relpath(cbuild.library_path(
        "fdt_tango", rings._NATIVE_SOURCES), ROOT), "seconds": time.time() - t0}
    ptxas = {
        n: [ln.strip() for ln in kbuild.build_log(n).splitlines()
            if "registers" in ln or "stack frame" in ln]
        for n in names
    }
    emit({"phase": "build", "kernels": names, "seconds": build_s,
          "ring_library": ring_lib, "ptxas": ptxas,
          "ptxas_summary": {n: ptxas_summary(kbuild.build_log(n)) for n in names}})

    # -- sass: the field products' multiply instructions, the card's rate ---
    probe_sass = kbuild.sass("probe/fe_probe")
    emit({"phase": "sass",
          "fe_mul": sass_counts(probe_sass, "fdt_probe_fe_mul"),
          "fe_sq": sass_counts(probe_sass, "fdt_probe_fe_sq"),
          "rate_kernel_imad_wide": sass_counts(probe_sass, "fdt_probe_imad_wide"),
          "msm_buckets_step_loop": loop_counts(kbuild.sass("msm"), MSM_KERNEL_SYMBOL),
          "measured": probe_rates(dev), "assumed_int32_mad_per_s": INT32_MAD_PER_S,
          "assumed_wide_mad_per_s": WIDE_MAD_PER_S})

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
    pack_select.LAUNCHES = 0
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
    slice_pack_launches = pack_select.LAUNCHES

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
    if slice_pack_launches != 1:
        raise AssertionError(f"pack_select launched {slice_pack_launches} times")
    n_golden = check_golden(golden, batches[1], ok_digest)
    emit({"phase": "slice", "steps": N_BATCHES, "metrics": metrics,
          "rotations": bloom.rotations, "golden_lanes_checked": n_golden,
          "pack_taken": int(want_take.sum()), "verify_core_launches": launches,
          "pack_select_launches": slice_pack_launches,
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
    # what the team kernels run: more products than the functions need
    vc_bound["kernel_int32_multiply_adds"] = VC.kernel_products_per_lane() * B
    msm_bound["kernel_int32_multiply_adds"] = MSM.msm_kernel_products(B, slots)
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

    # -- 8. lanes sweep: is the card full? ----------------------------------
    tile = lambda ts, n: [t.repeat(1, n // B).contiguous() for t in ts]  # noqa: E731
    sweep = {"verify_core": {}, "decompress_niels": {}}
    for lanes in (B, 2 * B, 4 * B):
        ins = tile(core_d, lanes)
        t_ms = cuda_ms(lambda: VC.verify_core(*ins), reps=20)
        bd = bound(VC.products_per_lane() * lanes,
                   nbytes(*ins) + lanes + VC.kernel_consts().nbytes)
        sweep["verify_core"][lanes] = {"ms": t_ms, "bound_ms": bd["bound_ms"],
                                       "bound_share": bd["bound_ms"] / t_ms}
    for lanes in (B, 2 * B):
        ins = tile(dn_h, lanes)
        t_ms = cuda_ms(lambda: MSM.decompress_niels(*ins), reps=20)
        bd = bound(MSM.decompress_niels_products_per_lane() * lanes,
                   nbytes(*ins) + 2 * 60 * 4 * lanes + lanes
                   + VC.kernel_consts().nbytes)
        sweep["decompress_niels"][lanes] = {"ms": t_ms, "bound_ms": bd["bound_ms"],
                                            "bound_share": bd["bound_ms"] / t_ms}
    sweep["msm_buckets"] = {}
    for lanes in (B, 2 * B):
        ins = tile(msm_h, lanes)
        t_ms = cuda_ms(lambda: MSM.msm_buckets(*ins), reps=20)
        out_bytes = MSM.NWIN * MSM.NBUCKET * 4 * F.NLIMB * MSM.slots_for(lanes) * 4
        bd = bound(MSM.msm_products(*ins[:2]), nbytes(*ins) + out_bytes)
        sweep["msm_buckets"][lanes] = {
            "slots": MSM.slots_for(lanes), "ms": t_ms, "bound_ms": bd["bound_ms"],
            "bound_share": bd["bound_ms"] / t_ms,
            "kernel_int32_multiply_adds": MSM.msm_kernel_products(lanes)}
    # lane slots: the kernel's parallelism against the finalization's
    # slot reduction, on the valid batch
    sweep["msm_slots"] = {}
    for s_ in (128, 256, 512):
        bk = MSM.msm_buckets(*msm_h, slots=s_)
        bk_plain = MSM.msm_buckets_plain(*msm_h, s_)
        sync()
        err = int((canon(bk) - canon(bk_plain)).abs().max())
        verdict = bool(MSM.msm_finalize(bk, ph["udig"]))
        if err != 0 or not verdict:
            raise AssertionError(f"msm_buckets at S = {s_}: error {err}, "
                                 f"verdict {verdict}")
        t_ms = cuda_ms(lambda: MSM.msm_buckets(*msm_h, slots=s_), reps=20)
        bd = bound(MSM.msm_products(ph["cdig"], ph["zdig"]), nbytes(*msm_h, bk))
        sweep["msm_slots"][s_] = {
            "ms": t_ms, "bound_ms": bd["bound_ms"], "bound_share": bd["bound_ms"] / t_ms,
            "kernel_int32_multiply_adds": MSM.msm_kernel_products(B, s_),
            "max_abs_err_canonical": err, "batch_ok": verdict,
            "msm_finalize_ms": cuda_ms(lambda: MSM.msm_finalize(bk, ph["udig"]), reps=3)}
    emit({"phase": "lanes_sweep", "sweep": sweep, "card": smi})

    ps_row = phase_pack_select(dev, put)
    rest = run_rest(dev, batches)
    ps_row["launches"] = run_multi(dev, batches, bloom, keeps, metrics, t_start)

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
    } for name, file, where, n, err in rows] + rest + [ps_row]})
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
