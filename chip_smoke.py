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
               signature held against hostpath.sign (golden's bytes, by
               tests/test_torch_hostpath.py) and every 16th against
               golden.sign
  keccak_blake3  keccak256 of the corpus's 4096 messages (256 seeded lanes
               against digest_host), blake3 of 4096 messages of 0-1024
               bytes (256 lanes against the CPU run, the empty-input vector)
  crossover    the shred path's two host/device switches: hashlib against
               sha256() from numpy for 1-4,096 rows at a FEC set's leaf
               width (1,070 B) and node width (66 B), and
               reedsol._encode_host against reedsol.encode on the card from
               numpy for the shredder's tail sets (1-16 data shreds) and 1-128
               full 32:32 sets, every card result held against the host's;
               the largest size at which the host was faster at every point
               up to it, beside ballet/bmtree.py's HOST_MAX_MSGS (the
               shredder encodes every set on the card: no switch)
  hmac         hmac_batch of 4,096 keys and messages for SHA-256 (two
               fdt_sha256_blocks launches) and SHA-512 (plain torch), every
               lane held against Python's hmac; ms of each beside Python's

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
               one warm-up, no fallback; run at a 1 ms idle sleep (the run
               loop's default 50 us run was dropped to keep the script in
               its time with the wire runs), and once more at 1 ms under
               torch.profiler for the card's kernel-time share; txns/s, e2e
               p50/p99 at the sink, the verify hop's p99, ms per device
               batch from the pool's dispatch and land stamps, and the busy
               shares; then at 1 ms on the native stem (stem="native":
               dedup's bursts in fdt_stem.c, stem_engaged and stem_frags
               checked); both runs with the run-loop profiler on (each
               tile's gil_wait_frac, phase split and sched_lag_p99_us,
               the aggregate, the render_rows table, the cores); then the
               Python run's twin in the process runtime
               (entry.ingress(runtime="process", profile=True): one OS
               process per tile, the verify child's own CUDA context),
               held to check_tiles through the sink's shm sig log (its
               partial batches allowed, its launches in the child:
               device_batches from the shm metrics), with its boot
               seconds and profile beside the thread run's; and a
               profiled pair (Python, native) at 1 ms for the card's
               kernel-time share; each run's stem_frags, py_frags and
               py_credit by tile
  wire         the wire front through entry.ingress(front="wire"): net ->
               quic (via_net) -> verify -> dedup -> sink over 127.0.0.1
               sockets, the tiles pool's raw txns 16 times in order as
               8,192 legacy datagrams (UdpBlaster, burst 64, its window
               the net tile's granted SO_RCVBUF over TRUESIZE less a
               burst, landed fed from the QUIC tile's rx_txns_udp at every
               1 ms poll) and 4 QUIC connections, in a spawned child,
               sending the pool's first 128 txns (32 each) after their
               handshakes, overlapping the legacy stream; on the
               Python loop, then on the native stem (net's rx hook and tx
               handler and dedup on fdt_stem.c); held exactly
               (check_wire): net received every datagram sent, no
               oversize drop, 8,192 legacy and 128 QUIC txns at quic, 4
               connections (conns_opened 12: ROADMAP C-5), every client
               established with the identity's key as its peer, verify's
               failures the corrupt sends, verify_core launches = device
               batches + the warm-up (partial batches: at least
               ceil(frags / 4096)), the 466 survivors equal the good tags
               and the tiles phase's survivors, each row its transaction
               and trailer byte for byte; legacy and QUIC txns/s,
               handshake ms, e2e p50/p99, the verify hop's p99, net's
               seconds in fdt_stem_run, the window and SO_RCVBUF, and each
               run's profile (as in tiles)
  leader       the leader pipeline through entry.leader: synth -> verify ->
               dedup -> pack (depth 4096, K = 1024 over 1024 account bits,
               2 ms cadence, 31 txns and 1.5M CU a microblock, its select
               on the pack_select kernel) -> bank x 2 (fee-only) -> poh
               (64 ticks a 400 ms slot) -> shred (its FEC sets' Merkle
               layers on the card above bmtree's switch, Reed-Solomon on
               the card)
               <-> sign -> store, with a recording sink beside the PoH tile
               on each bank's ring; seven runs: the tiles phase's pool as
               8,192 frags with select on and off at 1 ms (the run
               loop's default 50 us run was dropped, and the frags
               quartered, for the wire and validator runs' time), and the
               first 4,096 of 8,192 distinct transfers over 1,024 payers
               (tiles/bench.py's corpus, signed on the card; the validator
               phase runs all 8,192) each once, paced so that pack's
               4,096-txn buffer never fills, select on, 1 ms; each 1 ms
               run twice, on the Python loop and on the native stem
               (stem="native": dedup, pack, poh and shred on fdt_stem.c,
               stem_engaged and stem_frags checked on those four), in
               pairs, the select-on 1 ms pair under torch.profiler for
               the card's busy share over the run; and a seventh run
               with the wire front (entry.leader(front="wire"), native
               stem, select on, 1 ms: 8,192 legacy datagrams of the
               pool and the 4 QUIC connections' 128 txns), held to check_wire's
               front counters too; held
               exactly: verify and dedup as in tiles, every good txn
               inserted by pack and none rejected, every good txn executed
               once with its fee, completions ==
               microblocks, the engine drained, no conflicting pair,
               pack_select launches == select calls, every call's chain
               steps within its bound, the first select calls' inputs held
               kernel against plain and host, both banks busy on the
               transfers; then the egress (check_egress): the PoH tile
               mixed every microblock and the stored mixins are SHA-256 of
               the sinks' microblocks (sha256() on the card against its
               plain version and hashlib), the stored entries chain and
               verify_entries on the card (against its plain version and a
               hashlib chain) gives each state, every slot that holds a
               mixin is stored, each FEC set's root rebuilt by bmtree's
               device path and by hashlib equals its proofs' and its
               signature verifies against the identity key, a resolver on
               the card rebuilds every block without each set's first data
               shred, the store completes each slot once, and the sign
               loop refused nothing and balances; txns/s, microblocks per
               bank, txns per microblock, e2e at the sinks, the select
               call's host ms and its share of the wall time, the chain's
               steps per call, the pack engine's schedule calls and host
               seconds, slots, FEC sets and shreds, the shred tile's
               seconds in _finish_slot (and ms a slot), the checks'
               seconds and kernel launches, each stem tile's seconds in
               fdt_stem_run, every tile's stem_frags, py_frags and
               py_credit, and the transfer pool's signing seconds
  validator    the validator as an operator boots it: app/config.py's parse
               of the repo's default TOML (its name and free loopback ports
               set) -> build_validator_topology(cfg, identity, blockstore,
               funk) on the card: net -> quic -> verify (4,096 lanes x
               1,232 B) -> dedup (4,194,302) -> pack (depth 4,096, 2 ms,
               31 txns) -> bank x 2 (funk-backed, the shared 16,384-slot
               account table) -> poh (400 ms, 64 ticks) -> shred <-> sign
               -> store, + metric + rpc, with a recording sink beside the
               PoH tile on each bank's ring; the transfer corpus's first
               4,096 transfers over 1,024 payers (signed on the card; cut
               from 8,192 for run C), each payer funded in a fresh Funk,
               3,968 as legacy datagrams and 128 over 4 QUIC connections,
               paced so that pack rejects none; run A the default TOML
               (Python loop, host select), run B [topo] stem = "native"
               with [tiles.pack] device_select = true, run C [topo]
               runtime = "process" (one OS process per tile; metric and
               rpc threads in this process), each profiled (every tile's
               gil_wait_frac, sched_lag_p99_us, the rows, the cores);
               held exactly against a dict ledger of the corpus
               (transfer_ledger): 4,096 executed, none failed, fees
               20,480,000, fast_txns (A, C) or native_txns (B) 4,096,
               every ledger account's balance in the banks' shared
               account table after the halt, and on A and B every funk
               account equal to the ledger and no account outside it but
               the sysvars and RPC getBalance of 64 sampled accounts (C:
               the bank children write pickled copies of the funk, so
               neither is held: ROADMAP C-8), RPC getTransactionCount,
               getSlot and getIdentity, GET /metrics 200 with the banks'
               executed_txns, a Monitor attached by name reading
               topo.metrics' bank counters, a third process's monitor
               (python -m firedancer_tpu_torch.app.monitor --once --json)
               showing every tile's profile row, check_egress (C: the
               sinks' shm logs of tags count the mixins; the shred
               child's queues are not read), verify_core launches =
               device batches + the warm-up (C: none in this process,
               device batches from the shm metrics, and nvidia-smi lists
               more compute apps while C runs than before it: its
               children's CUDA contexts), pack_select launches = select
               calls, no workspace file left, and on B check_stem (net, dedup,
               pack, poh and shred handle frags on the stem; both banks'
               handler runs and hands back every microblock, each holding
               a destination the shared table has not seen); then fdtctl
               run --full from a TOML file in a subprocess, with fdtctl
               monitor, GET /metrics and RPC getHealth while it runs, and
               no workspace file left after its exit
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


def _host_sign_chunk(items):
    """Worker: hostpath.sign of (secret, message) pairs."""
    sys.path.insert(0, ROOT)
    from firedancer_tpu_torch.ops.ed25519 import hostpath

    return [hostpath.sign(sk, m) for sk, m in items]


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
    profiles it took ("_tries"): the first profile that saw at least
    calls - 1 kernel events, else the one that saw the most; raises where
    `tries` profiles in a row showed no device event.  The profiler may
    miss events of a short kernel (one call saw 2 of 10), never add one,
    so a profile that saw fewer is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, seen = None, -1
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
        kernels = sum(v for k, v in out.items() if k != "_copies")
        if out and kernels > seen:
            best, seen = {**out, "_calls": calls, "_tries": tried}, kernels
        if best is not None and seen >= calls - 1:
            break
    if best is None:
        raise AssertionError(f"torch.profiler saw no device event in {tries} profiles")
    return best


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


#: the sign phase's lanes held against golden.sign too (every 16th)
SIGN_GOLDEN_STRIDE = 16


def phase_sign(dev, bt) -> None:
    """sign_many over B distinct keys and messages, every signature held
    against hostpath.sign (byte for byte golden.sign's:
    tests/test_torch_hostpath.py) and every SIGN_GOLDEN_STRIDE-th against
    golden.sign itself, in a pool of host processes (golden on every lane
    took 130-180 s of the script's time)."""
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
    sampled = list(range(0, n, SIGN_GOLDEN_STRIDE))
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(procs) as pool:
        host = pool.map(_host_sign_chunk, [pairs[i::procs] for i in range(procs)])
        t1 = time.time()
        gold = pool.map(_golden_sign_chunk,
                        [[pairs[k] for k in sampled[i::procs]] for i in range(procs)])
    golden_s = time.time() - t1
    want = [None] * n
    for i, part in enumerate(host):
        want[i::procs] = part
    want_golden = [None] * len(sampled)
    for i, part in enumerate(gold):
        want_golden[i::procs] = part
    if sigs != want:
        raise AssertionError("sign_many differs from hostpath.sign")
    if [sigs[k] for k in sampled] != want_golden:
        raise AssertionError("sign_many differs from golden.sign")
    emit({"phase": "sign", "lanes": n, "distinct_keys": len({p[0] for p in pairs}),
          "all_match_hostpath": True, "golden_lanes_matched": len(sampled),
          "sign_many_seconds": sign_s,
          "signs_per_s": n / sign_s, "base_mul_compress_ms": base_ms,
          "hostpath_seconds": t1 - t0, "golden_seconds": golden_s,
          "processes": procs, "card": nvidia_smi_line()})


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
# the block egress: host/device switches, HMAC, the stored blocks' checks
# ---------------------------------------------------------------------------

#: the crossover sweeps: Merkle-layer rows at a FEC set's leaf width (the
#: 26-byte prefix and a parity leaf's 1,044 bytes) and node width (the
#: prefix and two 20-byte nodes); Reed-Solomon sets by data shreds (the
#: shredder's tail sets, a tick-only slot's is 1) and full 32:32 sets side
#: by side; host-clock repetitions per point
XOVER_ROWS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
XOVER_WIDTHS = {"leaf": 1070, "node": 66}
XOVER_TAIL_DATA = (1, 2, 4, 8, 16)
XOVER_FULL_SETS = (1, 2, 4, 8, 16, 32, 64, 128)
XOVER_REPS = 7


def host_ms(fn, reps: int = XOVER_REPS) -> float:
    """Median host-clock ms of fn() after one warm-up call; fn returns host
    data, so the card's work is inside the time."""
    fn()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _host_prefix(points, key) -> int:
    """The largest key of the points (sorted by it) up to which the host
    was faster at every point; 0 when it lost the first."""
    best = 0
    for p in sorted(points, key=lambda p: p[key]):
        if p["host_ms"] >= p["card_ms"]:
            break
        best = p[key]
    return best


def phase_crossover(dev) -> None:
    """The two host/device switches of the shred path, measured: hashlib
    against sha256() from numpy for a Merkle layer (ballet/bmtree.py's
    HOST_MAX_MSGS) and reedsol._encode_host against reedsol.encode on the
    card from numpy for a FEC set (disco/shredder.py encodes every set on
    the card).  Every card result is held against the host's.  Prints the
    largest row count and data size at which the host was faster at every
    point up to it, beside HOST_MAX_MSGS."""
    from firedancer_tpu_torch.ballet import bmtree as BM
    from firedancer_tpu_torch.disco import shredder as SD
    from firedancer_tpu_torch.ops import reedsol as RS
    from firedancer_tpu_torch.ops import sha256 as S

    t0 = time.time()
    rng = np.random.default_rng(2040)
    layers = {}
    for name, w in XOVER_WIDTHS.items():
        pts = []
        for n in XOVER_ROWS:
            msgs = rng.integers(0, 256, (n, w), np.uint8)
            lens = np.full(n, w, np.int32)
            if not np.array_equal(S.sha256(msgs, lens, device=dev).cpu().numpy(),
                                  BM.host_sha_batch(msgs, lens)):
                raise AssertionError(f"sha256 differs from hashlib at {n} x {w}")
            pts.append({"rows": n, "host_ms": host_ms(lambda: BM.host_sha_batch(msgs, lens)),
                        "card_ms": host_ms(lambda: S.sha256(
                            msgs, lens, device=dev).cpu().numpy())})
        layers[name] = pts
    rs = []
    shapes = [(d, SD.DATA_TO_PARITY[d], 1) for d in XOVER_TAIL_DATA] + [
        (32, 32, k) for k in XOVER_FULL_SETS]
    for d, p, k in shapes:
        cov = 1115 - 20 * SD.tree_depth_for(d + p) + 0x58 - 0x40
        data = rng.integers(0, 256, (d, k * cov), np.uint8)
        RS._parity_bits_matrix(d, p)  # the host's one warm-up: its matrix
        t = time.perf_counter()
        want = RS._encode_host(data, p)  # seconds at 32+ sets: timed once
        host = (time.perf_counter() - t) * 1e3
        if not np.array_equal(RS.encode(data, p, device=dev).cpu().numpy(), want):
            raise AssertionError(f"encode differs from _encode_host at {d}:{p} x {k}")
        rs.append({"data_shreds": d, "parity_shreds": p, "sets": k, "bytes": data.size,
                   "host_ms": host, "card_ms": host_ms(lambda: RS.encode(
                       data, p, device=dev).cpu().numpy(), reps=3)})
    rows_max = min(_host_prefix(pts, "rows") for pts in layers.values())
    emit({"phase": "crossover", "bmtree": layers, "reedsol": rs,
          "measured": {"bmtree_host_max_msgs": rows_max,
                       "rs_host_max_bytes": _host_prefix(rs, "bytes")},
          "module": {"bmtree_host_max_msgs": BM.HOST_MAX_MSGS},
          "card": nvidia_smi_line(), "seconds": time.time() - t0})


HMAC_LANES, HMAC_WIDTH = 4096, 256


def phase_hmac(dev) -> None:
    """hmac_batch of HMAC_LANES keys and messages (0-256 bytes) for SHA-256
    (two fdt_sha256_blocks launches) and SHA-512 (plain torch) on the card,
    every lane held against Python's hmac; host-clock ms of each from numpy
    beside Python's loop."""
    import hmac as pyhmac

    from firedancer_tpu_torch.ballet import hmac as H
    from firedancer_tpu_torch.ops import sha256 as S

    rng = np.random.default_rng(2041)
    keys = rng.integers(0, 256, (HMAC_LANES, 32), np.uint8)
    msgs = rng.integers(0, 256, (HMAC_LANES, HMAC_WIDTH), np.uint8)
    lens = rng.integers(0, HMAC_WIDTH + 1, HMAC_LANES)
    out = {}
    for algo in ("sha256", "sha512"):
        before = S.LAUNCHES["sha256_blocks"]
        got = H.hmac_batch(algo, keys, msgs, lens, device=dev)
        launches = S.LAUNCHES["sha256_blocks"] - before

        def python():
            return [pyhmac.new(keys[i].tobytes(), msgs[i, : lens[i]].tobytes(),
                               algo).digest() for i in range(HMAC_LANES)]

        want = python()
        bad = [i for i in range(HMAC_LANES) if got[i].tobytes() != want[i]]
        if bad:
            raise AssertionError(f"hmac {algo}: lanes {bad[:8]} differ from hmac")
        if launches != (2 if algo == "sha256" else 0):
            raise AssertionError(f"hmac {algo}: {launches} fdt_sha256_blocks launches")
        out[algo] = {"lanes_checked": HMAC_LANES, "sha256_blocks_launches": launches,
                     "card_ms": host_ms(lambda: H.hmac_batch(algo, keys, msgs, lens,
                                                             device=dev), reps=3),
                     "python_hmac_ms": host_ms(python, reps=3)}
    emit({"phase": "hmac", "lanes": HMAC_LANES, "max_msg_len": HMAC_WIDTH,
          "key_len": 32, **out, "card": nvidia_smi_line()})


def _entries(block: bytes) -> list:
    """A stored block -> its PoH entries as (prev, hashcnt, mixin, state)."""
    from firedancer_tpu_torch.tiles.poh import ENTRY_SZ

    if len(block) % ENTRY_SZ:
        raise AssertionError(f"a block of {len(block)} bytes is not whole entries")
    return [(block[o : o + 32], int.from_bytes(block[o + 32 : o + 40], "little"),
             block[o + 40 : o + 72], block[o + 72 : o + 104])
            for o in range(0, len(block), ENTRY_SZ)]


def _fec_sets(shreds: list) -> dict:
    """A slot's stored shreds -> {fec_set_idx: (leaves in leaf order, the
    set's shreds parsed)}: a data leaf is [0x40, 0x40 + cov), a parity
    leaf [0x40, 0x59 + cov) (disco/shredder.py)."""
    from firedancer_tpu_torch.ballet import shred as SH

    sets = {}
    for raw in shreds:
        s = SH.parse(raw)
        if s is None:
            raise AssertionError("a stored shred does not parse")
        sets.setdefault(s.fec_set_idx, []).append((s, raw))
    out = {}
    for idx, group in sets.items():
        depth = SH.merkle_cnt(group[0][0].variant)
        cov = 1115 - 20 * depth + SH.DATA_HEADER_SZ - 0x40
        d_cnt = next((s.data_cnt for s, _ in group if not s.is_data), None)
        leaves = {}
        for s, raw in group:
            if s.is_data:
                leaves[s.idx - s.fec_set_idx] = raw[0x40 : 0x40 + cov]
            else:
                leaves[s.data_cnt + s.code_idx] = raw[0x40 : SH.CODE_HEADER_SZ + cov]
        if d_cnt is None or sorted(leaves) != list(range(len(leaves))):
            raise AssertionError(f"FEC set {idx}: stored shreds leave a gap")
        out[idx] = ([leaves[i] for i in range(len(leaves))], group)
    return out


def check_egress(r, dev) -> dict:
    """The leader run's block egress, checked exactly after the run; raises
    on any miss; -> what was stored and checked, with the kernel launches
    the checks made (held against plain versions and hashlib, so not the
    run's).

    Mixins: the PoH tile mixed every executed microblock, and the multiset
    of stored mixins equals SHA-256 of each microblock the sinks recorded
    (sha256() on `dev`, held against sha256_bytes_plain and hashlib).
    Entries: the stored blocks' entries form one chain, and verify_entries
    on `dev` over every entry (held against poh_chain_bytes_plain and a
    hashlib chain) gives each entry's state.  Roots and signatures: each FEC
    set's root rebuilt by bmtree's device path (HOST_MAX_MSGS set to 0) and
    by hashlib equals the one its proofs give, and its signature verifies
    against the identity key (hostpath.verify_digest, whose verdicts are
    golden's, a few ms each; the first set's by golden too).  Receiver path: without the first data shred
    of every set, a fresh FecResolver on `dev` rebuilds each stored block
    bit for bit.  Sign loop: nothing refused, requests == responses +
    pending - queued.

    A process run's sinks log each microblock's SHA-256 in shm, not the
    microblock (`microblock_sha256`, tiles/sink.py shm_hash): there the
    stored mixins equal those digests, and sha256() is not called.  Its
    shred tile's queues stay in its child, so its sign loop is held to
    nothing refused and responses <= requests (every stored set's
    signature is verified above all the same)."""
    import hashlib

    from firedancer_tpu_torch.ballet import bmtree as BM
    from firedancer_tpu_torch.ballet import shred as SH
    from firedancer_tpu_torch.disco.fec_resolver import FecResolver, shred_merkle_root
    from firedancer_tpu_torch.ops import poh as POH
    from firedancer_tpu_torch.ops import sha256 as S
    from firedancer_tpu_torch.ops.ed25519 import golden, hostpath

    before = dict(S.LAUNCHES)
    secs = {}
    t0 = time.perf_counter()
    c = r["counters"]
    banks = [k for k in c if k.startswith("bank")]
    executed = sum(c[b]["executed_microblocks"] for b in banks)
    mbs = r["microblock_payloads"]
    want = r["microblock_sha256"] if mbs is None else None
    sunk = len(want if mbs is None else mbs)
    p = c["poh"]
    if not (p["mixins"] == executed == sunk) or p["dropped_mixins"] or p["replayed_mixins"]:
        raise AssertionError(f"poh mixed {p['mixins']} of {executed} microblocks "
                             f"({sunk} at the sinks)")
    blocks, shreds = r["blockstore"]["blocks"], r["blockstore"]["shreds"]
    missing = [s for s in range(r["slots_mixed"]) if blocks.get(s) is None]
    if missing:
        raise AssertionError(f"slots {missing[:8]} hold mixins but were not stored")
    stored = sorted(s for s, b in blocks.items() if b is not None)

    # -- mixins: SHA-256 of each microblock, three ways ----------------------
    import torch

    entries = [e for s in stored for e in _entries(blocks[s])]
    mixins = sorted(e[2] for e in entries if e[1] == 1)
    if mbs is not None:
        width = max(len(m) for m in mbs)
        msgs = np.zeros((len(mbs), width), np.uint8)
        lens = np.array([len(m) for m in mbs], np.int64)
        for i, m in enumerate(mbs):
            msgs[i, : len(m)] = np.frombuffer(m, np.uint8)
        msgs_d, lens_d = torch_from(msgs, dev), torch_from(lens, dev)
        hashed = S.sha256(msgs_d, lens_d, device=dev).cpu().numpy()
        plain = S.sha256_bytes_plain(msgs_d, lens_d).cpu().numpy()
        want = [hashlib.sha256(m).digest() for m in mbs]
        if not (np.array_equal(hashed, plain)
                and [h.tobytes() for h in hashed] == want):
            raise AssertionError("sha256() of the microblocks differs from its plain "
                                 "version or hashlib")
    if mixins != sorted(want):
        raise AssertionError(f"the stored mixins ({len(mixins)}) differ from the "
                             f"sinks' microblocks ({len(want)})")

    secs["mixins"] = time.perf_counter() - t0

    # -- entries: one chain, verified on the card ----------------------------
    t0 = time.perf_counter()
    for i, (a, b) in enumerate(zip(entries, entries[1:])):
        if b[0] != a[3]:
            raise AssertionError(f"entry {i + 1}'s prev is not entry {i}'s state")
    n = len(entries)
    start = np.stack([np.frombuffer(e[0], np.uint8) for e in entries])
    mix = np.stack([np.frombuffer(e[2], np.uint8) for e in entries])
    hcnt = np.array([e[1] for e in entries], np.int32)
    has = hcnt == 1
    end = POH.verify_entries(start, hcnt, mix, has, max_hashcnt=64, device=dev)
    plain = S.poh_chain_bytes_plain(torch_from(start, dev),
                                    torch_from(np.where(has, hcnt - 1, hcnt), dev),
                                    torch_from(mix, dev), torch_from(has, dev))
    host = []
    for prev, k, m, _ in entries:
        st = prev
        if k == 1:
            st = hashlib.sha256(st + m).digest()
        else:
            for _ in range(k):
                st = hashlib.sha256(st).digest()
        host.append(st)
    states = [e[3] for e in entries]
    if not (torch.equal(end, plain) and [bytes(x) for x in end.cpu().numpy()] == states
            and host == states):
        raise AssertionError("verify_entries, its plain version or hashlib "
                             "disagrees with the stored entries' states")

    secs["entries"] = time.perf_counter() - t0

    # -- roots and signatures ------------------------------------------------
    t0 = time.perf_counter()
    sets = {(s, i): v for s in stored for i, v in _fec_sets(shreds[s]).items()}
    orig = BM.HOST_MAX_MSGS
    try:
        BM.HOST_MAX_MSGS = 0
        roots_card = {k: BM.commit(leaves, 20, device=dev) for k, (leaves, _) in sets.items()}
        BM.HOST_MAX_MSGS = 1 << 30
        roots_host = {k: BM.commit(leaves, 20, device=dev) for k, (leaves, _) in sets.items()}
    finally:
        BM.HOST_MAX_MSGS = orig
    verified = set()
    pub = r["identity"]
    for k, (_leaves, group) in sets.items():
        s0, raw0 = group[0]
        root = shred_merkle_root(s0, raw0, device=dev)
        sigs = {s.signature for s, _ in group}
        if roots_card[k] != root or roots_host[k] != root:
            raise AssertionError(f"FEC set {k}: rebuilt roots differ from its proofs'")
        sig = s0.signature
        digest = hashlib.sha512(sig[:32] + pub + root).digest()
        if (len(sigs) != 1 or not hostpath.verify_digest(digest, sig, pub)
                or (not verified and golden.verify(root, sig, pub) != 0)):
            raise AssertionError(f"FEC set {k}: signature does not verify")
        verified.add((sig, root))

    secs["roots_and_signatures"] = time.perf_counter() - t0

    # -- receiver path -------------------------------------------------------
    t0 = time.perf_counter()
    resolver = FecResolver(verify_sig=lambda sig, root, _s: (sig, root) in verified,
                           device=dev)
    recovered = 0
    for s in stored:
        drop = {(sh.fec_set_idx, sh.idx) for _l, group in _fec_sets(shreds[s]).values()
                for sh, _ in group if sh.is_data and sh.idx == sh.fec_set_idx}
        got = {}
        for raw in shreds[s]:
            sh = SH.parse(raw)
            if sh.is_data and (sh.fec_set_idx, sh.idx) in drop:
                continue
            res = resolver.add_shred(raw)
            if res is not None:
                got[res.fec_set_idx] = res
                recovered += res.recovered_cnt
        if b"".join(got[i].payload for i in sorted(got)) != blocks[s]:
            raise AssertionError(f"slot {s}: the receiver's payload differs from the block")
    if resolver.rejected or recovered != len(sets):
        raise AssertionError(f"receiver: {resolver.rejected} rejected, {recovered} "
                             f"shreds recovered for {len(sets)} sets")
    secs["receiver"] = time.perf_counter() - t0
    if c["store"]["completed_slots"] != len(stored):
        raise AssertionError(f"the store completed {c['store']['completed_slots']} "
                             f"slots for {len(stored)} stored blocks")

    # -- the sign loop -------------------------------------------------------
    sh, sg, st = c["shred"], c["sign"], c["store"]
    t = r["shred_tile"]
    if sg["refused"] or (sh["sign_responses"] > sh["sign_requests"] if t is None else
                         sh["sign_requests"] != sh["sign_responses"] + t["pending"]
                         - t["signq"]):
        raise AssertionError(f"sign loop: refused {sg['refused']}, requests "
                             f"{sh['sign_requests']}, responses {sh['sign_responses']}, "
                             f"{t}")
    return {"slots_mixed": r["slots_mixed"], "slots_stored": len(stored),
            "entries": n, "max_entries_per_slot": max(len(_entries(blocks[s]))
                                                      for s in stored),
            "mixins": len(mixins), "fec_sets": len(sets),
            "data_shreds": sh["data_shreds"], "parity_shreds": sh["parity_shreds"],
            "shredded_fec_sets": sh["fec_sets"], "sign_requests": sh["sign_requests"],
            "sign_responses": sh["sign_responses"], "signed": sg["signed"],
            "store_completed_slots": st["completed_slots"],
            "store_completed_sets": st["completed_sets"],
            "receiver_recovered_shreds": recovered,
            "poh": {k: p[k] for k in ("hashcnt", "mixins", "entries", "slots")},
            "check_launches": {k: S.LAUNCHES[k] - before[k] for k in S.LAUNCHES},
            "check_seconds": secs}


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


#: the tiles phase: pool size, frags streamed, pool seed
TILES_POOL, TILES_FRAGS, TILES_SEED = 512, 65536, 5
#: the tiles phase's runs: (the run loop's idle sleep, its inner loop; 1 ms,
#: at which idle tile threads stop starving the verify worker of the GIL);
#: each native run follows its Python twin, and the profiled pair runs
#: after them at the last idle sleep
TILES_RUNS = ((1e-3, "python"), (1e-3, "native"))
#: the tiles phase's process run (one OS process per tile): the first
#: thread run's idle sleep and inner loop
TILES_PROCESS_RUN = TILES_RUNS[0]
#: the tiles that run on the native stem under stem="native", by phase
STEM_TILES = {"tiles": ("dedup",), "leader": ("dedup", "pack", "poh", "shred"),
              "wire": ("net", "dedup"),
              "wire_leader": ("net", "dedup", "pack", "poh", "shred"),
              "validator": ("net", "dedup", "pack", "bank0", "bank1", "poh", "shred")}


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


#: the per-tile keys of a profile row that the phase lines carry
#: (oversleep: an idle sleep's overrun, which holds the GIL's reacquisition
#: after it; gil_wait_frac leaves sleeps out, so it cannot show that wait)
PROFILE_ROW_KEYS = ("gil_wait_frac", "sched_lag_p99_us", "samples", "busy_wall_ns",
                    "sleep_ns", "oversleep_ns", "frag_frac", "hk_frac", "credit_frac",
                    "bp_frac", "frag_gil_wait_frac")


def profile_summary(prof) -> dict | None:
    """A run's `profile` block (disco/profile.aggregate with its `rows`
    table and `cores`) -> the phase line's: the aggregate's gil_wait_frac,
    sched_lag_p99_us and samples of the merged lag, the CPUs the script
    may run on (with fewer cores than runnable tiles, gil_wait counts run
    queue wait too), each tile's PROFILE_ROW_KEYS and the table's lines."""
    if prof is None:
        return None
    return {"gil_wait_frac": prof["gil_wait_frac"],
            "sched_lag_p99_us": prof["sched_lag_p99_us"],
            "sched_lag_n": prof["sched_lag_n"], "cores": prof["cores"],
            "tiles": {n: {k: row[k] for k in PROFILE_ROW_KEYS}
                      for n, row in prof["tiles"].items()},
            "rows": prof["rows"].splitlines()}


def check_tiles_front(r, launches: int | None, frags: int = TILES_FRAGS) -> None:
    """The verify and dedup tiles' exact checks (tiles and leader phases):
    `frags` frags streamed as whole passes over the pool, then its first
    frags % len(pool) rows once more (the wire runs' QUIC part).  A paced leader
    run's synth releases frags as the banks execute them, a wire run's
    senders pace theirs, and a process run's verify child drains its ring
    while the synth child fills it, so those verify tiles land partial
    batches: as many as the timing gives, at least ceil(frags / B); every
    other run lands full batches only.  launches: verify_core's in the
    process that ran the verify tile (a child's as it published them),
    held to one a batch and one warm-up; None: not held."""
    c = r["counters"]
    v = c["verify"]
    good = r["pool"]["good"]
    passes, rem = divmod(frags, len(good))
    n_good, good_rem = int(good.sum()), int(good[:rem].sum())
    sent_good = n_good * passes + good_rem
    batches = v["device_batches"]
    want = {
        ("verify", "in_frags"): frags,
        ("verify", "verify_fail_txns"): frags - sent_good,
        ("verify", "out_frags"): sent_good,
        ("verify", "device_batches"): (max(batches, -(-frags // B))
                                       if r.get("paced") or "wire" in r
                                       or r.get("runtime") == "process"
                                       else frags // B),
        ("verify", "fallback_batches"): 0,
        ("verify", "device_errors"): 0,
        ("verify", "device_trips"): 0,
        ("dedup", "dup_txns"): sent_good - (n_good if passes else good_rem),
        ("dedup", "out_frags"): n_good if passes else good_rem,
    }
    got = {k: c[k[0]][k[1]] for k in want}
    if got != want:
        raise AssertionError(f"verify/dedup counters {got} != {want}")
    if launches is not None and launches != v["device_batches"] + 1:
        raise AssertionError(f"verify_core launched {launches} times for "
                             f"{v['device_batches']} batches and one warm-up")


def check_tiles(r, launches: int | None, frags: int = TILES_FRAGS) -> None:
    """The tiles phase's exact checks; raises on any miss.  A process run
    (r["payloads"] None) holds its survivors from the sink's shm sig log,
    which keeps no payloads."""
    check_tiles_front(r, launches, frags)
    c = r["counters"]
    v, d = c["verify"], c["dedup"]
    good = r["pool"]["good"]
    n_good = int(good.sum())
    if c["sink"]["sunk_frags"] != n_good:
        raise AssertionError(f"sink took {c['sink']['sunk_frags']} of {n_good}")
    if not np.array_equal(r["survivors"], r["pool"]["tags"][good]):
        raise AssertionError("sink survivors differ from the pool's good tags")
    if r["payloads"] is not None and not (
            np.array_equal(r["payloads"], r["pool"]["rows"][good])
            and np.array_equal(r["sizes"], r["pool"]["szs"][good])):
        raise AssertionError("sink payloads differ from the pool's rows")
    if d["in_frags"] != v["out_frags"]:
        raise AssertionError(f"dedup took {d['in_frags']} of {v['out_frags']}")


def check_stem(r, tiles, handback=()) -> None:
    """A stem="native" run engaged the stem on exactly `tiles`, and each of
    them but those of `handback` handled frags on it; raises otherwise.
    A `handback` tile's handler may hand every frag back to the Python
    loop (a bank whose every microblock holds an account the shared table
    has not seen); the caller checks what it executed."""
    st = r["stem"]["tiles"]
    engaged = sorted(n for n, c in st.items() if c["stem_engaged"])
    idle = [n for n in tiles if n not in handback and st[n]["stem_frags"] <= 0]
    if r["stem"]["mode"] != "native" or engaged != sorted(tiles) or idle:
        raise AssertionError(f"stem engaged on {engaged}, not {sorted(tiles)}; "
                             f"no stem frags on {idle}")


def stem_counts(r) -> dict:
    """Every tile's stem_frags, py_frags and py_credit of a run."""
    return {n: {k: c[k] for k in ("stem_frags", "py_frags", "py_credit")}
            for n, c in r["stem"]["tiles"].items()}


def kernel_share(run, wall: str = "seconds") -> tuple:
    """One pipeline run under torch.profiler (CUDA activity only): the
    card's summed device time over the run's wall time (the report's
    `wall` key: `seconds` for tiles, `egress_seconds`, to the last stored
    slot, for leader).  The profile also holds the verify tile's warm-up
    batch, one more batch of equal device work than the run's, so its
    share is taken out; and the device ms of the five costliest kernels.
    -> ({"device_ms", "share", "top_kernels_ms"}, or {"not_measured":
    reason} when the profiler shows no device time; the run's report)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r = run()
    rows = [(e.key, getattr(e, "self_device_time_total", 0) or 0)
            for e in prof.key_averages()]
    dev_us = sum(us for _, us in rows)
    if dev_us <= 0:
        return {"not_measured": "torch.profiler showed no device time"}, r
    batches = r["counters"]["verify"]["device_batches"]
    dev_us *= batches / (batches + 1)
    top = sorted(rows, key=lambda kv: -kv[1])[:5]
    return {"device_ms": dev_us / 1e3, "share": dev_us / 1e6 / r[wall],
            "top_kernels_ms": {k: us / 1e3 for k, us in top}}, r


def phase_tiles() -> None:
    """The ingress tile pipeline on the card through entry.ingress, at the
    verify tile's deployment size; see the module docstring."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.tiles.synth import make_txn_pool

    t0 = time.time()
    pool = make_txn_pool(TILES_POOL, corrupt_frac=0.1, seed=TILES_SEED)

    def run(idle_s, stem, profile=False, runtime=None):
        r = entry.ingress(pool, total=TILES_FRAGS, max_lanes=B,
                          idle_sleep_s=idle_s, stem=stem, profile=profile,
                          runtime=runtime)
        if stem == "native":
            check_stem(r, STEM_TILES["tiles"])
        return r

    runs = []
    for idle_s, stem in TILES_RUNS:
        sync()
        VC.LAUNCHES = 0
        r = run(idle_s, stem, profile=True)
        sync()
        launches = VC.LAUNCHES
        check_tiles(r, launches, TILES_FRAGS)
        runs.append({
            "idle_sleep_us": idle_s * 1e6, "stem": stem, "runtime": r["runtime"],
            "txns_per_s": r["txns_per_s"], "seconds": r["seconds"],
            "boot_seconds": r["boot_seconds"], "e2e_p50_us": r["e2e_p50_us"],
            "e2e_p99_us": r["e2e_p99_us"], "verify_hop_p99_us": r["verify_hop_p99_us"],
            "device_batches": r["counters"]["verify"]["device_batches"],
            "verify_core_launches_after_warmup": launches - 1,
            "stem_counts": stem_counts(r), "profile": profile_summary(r["profile"]),
            **stamps_summary(r["landed_stamps"], r["seconds"])})
    # the Python-loop thread run's twin with one OS process per tile: the
    # verify child launches the kernels (it publishes its count and its
    # CUDA context as it exits), the sink's shm log holds the survivors
    idle_s, stem = TILES_PROCESS_RUN
    sync()
    VC.LAUNCHES = 0
    r = run(idle_s, stem, profile=True, runtime="process")
    sync()
    vdev = r["children"]["verify"]
    if VC.LAUNCHES or not vdev["cuda"]:
        raise AssertionError(f"the process run launched verify_core {VC.LAUNCHES} "
                             f"times in this process; the verify child {vdev}")
    launches = vdev["launches"]["verify_core"]
    check_tiles(r, launches, TILES_FRAGS)
    runs.append({
        "idle_sleep_us": idle_s * 1e6, "stem": stem, "runtime": r["runtime"],
        "txns_per_s": r["txns_per_s"], "seconds": r["seconds"],
        "boot_seconds": r["boot_seconds"], "e2e_p50_us": r["e2e_p50_us"],
        "e2e_p99_us": r["e2e_p99_us"], "verify_hop_p99_us": r["verify_hop_p99_us"],
        "device_batches": r["counters"]["verify"]["device_batches"],
        "verify_core_launches_after_warmup": launches - 1,
        "children_with_cuda": sorted(n for n, d in r["children"].items() if d["cuda"]),
        "landed_stamps": r["landed_stamps_note"], "profile": profile_summary(r["profile"])})
    idle_s = TILES_RUNS[-1][0]
    shares = []
    for stem in ("python", "native"):
        share, r = kernel_share(lambda: run(idle_s, stem))
        check_tiles(r, r["counters"]["verify"]["device_batches"] + 1, TILES_FRAGS)
        shares.append({"idle_sleep_us": idle_s * 1e6, "stem": stem,
                       "txns_per_s": r["txns_per_s"], **share})
    emit({"phase": "tiles", "pool": TILES_POOL, "frags": TILES_FRAGS, "lanes": B,
          "msg_width": W, "n_good": int(pool[2].sum()), "checks": "exact", "runs": runs,
          "kernel_time_share": shares, "card": nvidia_smi_line(),
          "seconds": time.time() - t0})
    return pool, r["survivors"]


#: the wire phase: legacy passes over the tiles phase's pool (8,192
#: datagrams: cut from 128 passes to pay for the validator phase's time,
#: then from 32 for the process runs'),
#: the QUIC connections, the pool's first rows they send between them (128:
#: cut from the whole pool, 512, for the same reason; QUIC ran at 7-18
#: txns/s and set the wire runs' length), the runs (the run loop's idle
#: sleep, its inner loop), Python first
WIRE_PASSES, WIRE_CLIENTS, WIRE_QUIC_TXNS = 16, 4, 128
WIRE_RUNS = ((1e-3, "python"), (1e-3, "native"))
#: legacy passes of the wire leader run (8,192 datagrams: cut from 64 passes
#: to pay for the validator phase's time)
WIRE_LEADER_PASSES = 16


def wire_traffic(pool, passes: int):
    """The wire runs' senders: the pool's raw txns `passes` times in order
    as legacy datagrams (a UdpBlaster) and its first WIRE_QUIC_TXNS over
    WIRE_CLIENTS QUIC connections; -> (WireTraffic, frags: every txn
    sent)."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.tiles.bench import WireTraffic

    raws = entry.raw_txns(pool)
    traffic = WireTraffic(raws * passes, raws[:WIRE_QUIC_TXNS], n_clients=WIRE_CLIENTS,
                          seed=TILES_SEED)
    return traffic, traffic.txns


def wire_identity() -> bytes:
    """The QUIC tile's identity key: 32 bytes from default_rng(TILES_SEED)."""
    return np.random.default_rng(TILES_SEED).integers(0, 256, 32, np.uint8).tobytes()


def check_wire(r, launches: int, n_legacy: int, identity_pub: bytes,
               tiles_survivors=None) -> None:
    """A wire run's exact checks (the wire front; verify, dedup and the sink
    as in check_tiles with the QUIC pass added); raises on any miss."""
    from firedancer_tpu_torch.tiles import wire as WI

    w, c = r["wire"], r["counters"]
    n_quic = sum(cl["txns"] for cl in w["quic_clients"])
    n_conns = len(w["quic_clients"])
    sent = w["dgrams_sent"]
    got = {"net_rx_dgrams": w["net_rx_dgrams"], "oversize_drops": w["oversize_drops"],
           "rx_txns_udp": w["rx_txns_udp"], "rx_txns_quic": w["rx_txns_quic"],
           "connections": w["connections"], "conns_opened": w["conns_opened"],
           "parse_fail_txns": c["quic"]["parse_fail_txns"]}
    want = {"net_rx_dgrams": sent["legacy"] + sent["quic"], "oversize_drops": 0,
            "rx_txns_udp": n_legacy, "rx_txns_quic": n_quic,
            "connections": n_conns, "conns_opened": 3 * n_conns,
            "parse_fail_txns": 0}
    if got != want or sent["legacy"] != n_legacy:
        raise AssertionError(f"wire counters {got} != {want} (legacy sent "
                             f"{sent['legacy']} of {n_legacy})")
    bad = [cl for cl in w["quic_clients"]
           if not cl["established"] or cl["peer_identity"] != identity_pub]
    if bad:
        raise AssertionError(f"QUIC clients not established or with another "
                             f"peer identity: {bad}")
    frags = n_legacy + n_quic
    check_tiles_front(r, launches, frags)
    good = r["pool"]["good"]
    rows, szs, tags = r["pool"]["rows"], r["pool"]["szs"], r["pool"]["tags"]
    if "sink" in c:
        if c["sink"]["sunk_frags"] != int(good.sum()):
            raise AssertionError(f"sink took {c['sink']['sunk_frags']} of {int(good.sum())}")
        if sorted(r["survivors"].tolist()) != sorted(tags[good].tolist()):
            raise AssertionError("sink survivors differ from the pool's good tags")
        if tiles_survivors is not None and (
                sorted(r["survivors"].tolist()) != sorted(tiles_survivors.tolist())):
            raise AssertionError("sink survivors differ from the tiles phase's")
        at = {int(t): i for i, t in enumerate(tags)}
        tr = WI.parse_trailers(rows, szs.astype(np.int64))
        for row, sz, tag in zip(r["payloads"], r["sizes"], r["survivors"]):
            i = at[int(tag)]
            n = tr["txn_sz"][i]
            if row[:n].tobytes() != rows[i, :n].tobytes() or not (
                    sz == szs[i] and np.array_equal(row[:sz], rows[i, :sz])):
                raise AssertionError(f"sink row of tag {int(tag):#x} differs from "
                                     "its transaction and trailer")


def phase_wire(pool, tiles_survivors) -> dict:
    """The wire front on the card through entry.ingress(front="wire"): net
    -> quic -> verify -> dedup -> sink over real loopback sockets, at the
    verify tile's deployment size; see the module docstring.  -> the
    verify_core launches of its runs."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.ops.ed25519 import hostpath
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.tango import rings as R

    t0 = time.time()
    identity = wire_identity()
    pub = hostpath.public_from_secret(identity)
    n_legacy = len(pool[0]) * WIRE_PASSES
    runs, launches_all = [], 0
    orig_stem_run = R.Stem.run
    for idle_s, stem in WIRE_RUNS:
        stem_s = {}

        def stem_run(self, *a, **kw):
            t = time.perf_counter()
            out = orig_stem_run(self, *a, **kw)
            name = STEM_HANDLER_TILES[self.spec.handler]
            stem_s[name] = stem_s.get(name, 0.0) + time.perf_counter() - t
            return out

        traffic, _frags = wire_traffic(pool, WIRE_PASSES)
        R.Stem.run = stem_run
        try:
            sync()
            VC.LAUNCHES = 0
            r = entry.ingress(pool, max_lanes=B, idle_sleep_s=idle_s, stem=stem,
                              front="wire", traffic=traffic, identity_secret=identity,
                              profile=True)
            sync()
            launches = VC.LAUNCHES
        finally:
            R.Stem.run = orig_stem_run
        check_wire(r, launches, n_legacy, pub, tiles_survivors)
        if stem == "native":
            check_stem(r, STEM_TILES["wire"])
        launches_all += launches
        w = r["wire"]
        runs.append({
            "idle_sleep_us": idle_s * 1e6, "stem": stem,
            "txns_per_s": r["txns_per_s"], "seconds": r["seconds"],
            "legacy_txns_per_s": w["legacy_txns_per_s"],
            "quic_txns_per_s": w["quic_txns_per_s"],
            "handshake_ms": w["handshake_ms"],
            "e2e_p50_us": r["e2e_p50_us"], "e2e_p99_us": r["e2e_p99_us"],
            "verify_hop_p99_us": r["verify_hop_p99_us"],
            "dgrams_sent": w["dgrams_sent"], "net_rx_dgrams": w["net_rx_dgrams"],
            "window": w["window"], "rcvbuf": w["rcvbuf"], "truesize": w["truesize"],
            "device_batches": r["counters"]["verify"]["device_batches"],
            "verify_core_launches_after_warmup": launches - 1,
            "stem_run_seconds": stem_s, "stem_counts": stem_counts(r),
            "profile": profile_summary(r["profile"]),
            "quic_tile": {k: r["counters"]["quic"][k] for k in (
                "rx_dgrams", "tx_dgrams", "rx_txns_udp", "rx_txns_quic",
                "conns_opened", "loop_iters")},
            **stamps_summary(r["landed_stamps"], r["seconds"])})
    emit({"phase": "wire", "pool": len(pool[0]), "legacy_passes": WIRE_PASSES,
          "quic_txns": WIRE_QUIC_TXNS,
          "quic_clients": WIRE_CLIENTS, "lanes": B, "msg_width": W,
          "n_good": int(pool[2].sum()), "checks": "exact", "runs": runs,
          "card": nvidia_smi_line(), "seconds": time.time() - t0})
    return {"verify_core": launches_all}


#: the leader phase's runs: (pool, pack device select, the run loop's idle
#: sleep, its inner loop); "tiles" is the tiles phase's pool and frags,
#: "transfers" the many-payer transfer corpus's first TRANSFER_LEADER_TXNS,
#: each frag once, paced (entry.leader's closed loop: more distinct txns
#: than pack's 4,096-txn buffer less the banks' in flight), "wire" the
#: tiles pool behind the wire front (16 legacy passes and the QUIC part).  Each native run sits next to its
#: Python twin, the pairs in turns (Python first, then native first), since
#: host-clock rates move between runs
LEADER_RUNS = (("tiles", True, 1e-3, "python"), ("tiles", True, 1e-3, "native"),
               ("tiles", False, 1e-3, "native"), ("tiles", False, 1e-3, "python"),
               ("transfers", True, 1e-3, "python"), ("transfers", True, 1e-3, "native"),
               ("wire", True, 1e-3, "native"))
#: the runs (pool, select, idle sleep) whose Python and native pair runs
#: under torch.profiler: the card's busy share under each loop
LEADER_PROFILED = ("tiles", True, 1e-3)
#: the stem handler ids (tango/rings.py STEM_H_*) by tile
STEM_HANDLER_TILES = {1: "dedup", 3: "pack", 4: "poh", 5: "shred", 6: "net"}
#: the transfer corpus: distinct signed transfers, payers, seed
#: (firedancer_tpu/tiles/bench.py's default payer count)
TRANSFER_TXNS, TRANSFER_SIGNERS, TRANSFER_SEED = 8192, 1024, 6
#: the leader phase's transfers runs take the corpus's first 4,096 (cut from
#: all 8,192, which the validator phase runs, to pay for its time)
TRANSFER_LEADER_TXNS = 4096
#: frags of each run on the tiles phase's pool (an eighth of TILES_FRAGS:
#: with the block egress a run took 34-46 s at 65,536 frags on one H100,
#: the wire runs took the script to 736 s at 32,768, and the validator
#: phase took 223 s more; it must stay within 750 s)
LEADER_FRAGS = 8192
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


def check_leader(r, vc_launches: int, frags: int = TILES_FRAGS) -> None:
    """The leader phase's exact checks up to the sinks; raises on any miss
    (check_egress checks the rest)."""
    from firedancer_tpu_torch.tiles import wire

    check_tiles_front(r, vc_launches, frags)
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


def transfer_pool(dev):
    """The many-payer corpus of the transfers run, signed on `dev`; ->
    (the wire pool, signing seconds)."""
    from firedancer_tpu_torch.tiles import bench as TB

    sync()
    t0 = time.time()
    rows, _payers = TB.make_transfer_pool(TRANSFER_TXNS, n_signers=TRANSFER_SIGNERS,
                                          seed=TRANSFER_SEED, device=dev)
    sync()
    return TB.wire_pool(rows), time.time() - t0


def phase_leader(dev, pool) -> dict:
    """The leader pipeline on the card through entry.leader (synth ->
    verify -> dedup -> pack -> bank x 2 -> poh -> shred <-> sign -> store,
    a sink beside the PoH tile on each bank's ring) at the verify tile's
    deployment size, seven runs (LEADER_RUNS: Python and native stem in
    pairs, one pair profiled); -> the first run's launches
    of pack_select (pack_select), and of the SHA-256 kernels during the run
    and in its egress checks (sha256_blocks, poh_chain).  The hooks on the
    pack and shred tiles' threads only keep references and times (the
    engine's arrays are fresh for each call); every check runs after the
    run."""
    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.ballet import pack as P
    from firedancer_tpu_torch.ops import pack_select as PS
    from firedancer_tpu_torch.ops import sha256 as S
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.tango import rings as R
    from firedancer_tpu_torch.tiles.shred import ShredTile

    t0 = time.time()
    PC = pack_cases_module()
    orig = PS.select_noconflict
    orig_sched, orig_spec = P.Pack.schedule_microblock, P.Pack._select_speculative
    orig_finish = ShredTile._finish_slot
    orig_stem_run = R.Stem.run
    tpool, sign_s = transfer_pool(dev)
    tsub = tuple(a[:TRANSFER_LEADER_TXNS] for a in tpool)
    pools = {"tiles": (pool, LEADER_FRAGS), "transfers": (tsub, TRANSFER_LEADER_TXNS),
             "wire": (pool, len(pool[0]) * WIRE_LEADER_PASSES + WIRE_QUIC_TXNS)}
    identity = wire_identity()
    wire_pub = None
    runs, first = [], None
    for kind, select, idle_s, stem in LEADER_RUNS:
        run_pool, frags = pools[kind]
        calls = []  # (args, take, the chain's steps, host ms)
        host_s = {"schedule": [], "speculative": [], "finish_slot": []}
        stem_s = {n: [] for n in STEM_HANDLER_TILES.values()}  # seconds a burst

        def stem_run(self, *a, **kw):
            t = time.perf_counter()
            out = orig_stem_run(self, *a, **kw)
            stem_s[STEM_HANDLER_TILES[self.spec.handler]].append(time.perf_counter() - t)
            return out

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
        ShredTile._finish_slot = timed(orig_finish, "finish_slot")
        R.Stem.run = stem_run
        try:
            sync()
            VC.LAUNCHES = 0
            PS.LAUNCHES = 0
            for k in S.LAUNCHES:
                S.LAUNCHES[k] = 0
            wire_kw = {}
            if kind == "wire":
                from firedancer_tpu_torch.ops.ed25519 import hostpath

                wire_pub = hostpath.public_from_secret(identity)
                traffic, _n = wire_traffic(run_pool, WIRE_LEADER_PASSES)
                wire_kw = {"front": "wire", "traffic": traffic,
                           "identity_secret": identity}

            def run():
                return entry.leader(run_pool, total=frags, max_lanes=B, n_banks=2,
                                    pack_device_select=select, idle_sleep_s=idle_s,
                                    paced=kind == "transfers", stem=stem, **wire_kw)

            share = None
            if (kind, select, idle_s) == LEADER_PROFILED:
                share, r = kernel_share(run, "egress_seconds")
            else:
                r = run()
            sync()
            vc_launches, ps_launches = VC.LAUNCHES, PS.LAUNCHES
            sha_launches = dict(S.LAUNCHES)
        finally:
            PS.select_noconflict = orig
            P.Pack.schedule_microblock = orig_sched
            P.Pack._select_speculative = orig_spec
            ShredTile._finish_slot = orig_finish
            R.Stem.run = orig_stem_run
        check_leader(r, vc_launches, frags)
        if kind == "wire":
            check_wire(r, vc_launches, len(run_pool[0]) * WIRE_LEADER_PASSES, wire_pub)
        if stem == "native":
            check_stem(r, STEM_TILES["wire_leader" if kind == "wire" else "leader"])
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
        egress = check_egress(r, dev)
        c = r["counters"]
        mb_banks = [c[f"bank{i}"]["executed_microblocks"] for i in range(2)]
        if kind == "transfers" and min(mb_banks) == 0:
            raise AssertionError(f"transfers: a bank executed no microblock {mb_banks}")
        if first is None:
            first = {"pack_select": ps_launches,
                     **{k: {"run": v, "egress_checks": egress["check_launches"][k]}
                        for k, v in sha_launches.items()}}
        if kind == "wire":
            first["wire"] = {"pack_select": ps_launches, "verify_core": vc_launches}
        mbs = c["pack"]["microblocks"]
        ms = [m for _, _, _, m in calls]
        steps = [n for _, _, n, _ in calls]
        runs.append({
            "pool": kind, "frags": frags, "paced": r["paced"], "stem": stem,
            "pack_device_select": select, "idle_sleep_us": idle_s * 1e6,
            "txns_per_s": r["txns_per_s"], "executed_per_s": r["executed_per_s"],
            "seconds": r["seconds"], "front_seconds": r["front_seconds"],
            "egress_seconds": r["egress_seconds"],
            "microblocks": mbs, "blocks": c["pack"]["blocks"],
            "pack_loop_iters": c["pack"]["loop_iters"],
            "mean_txns_per_microblock": c["pack"]["microblock_txns"] / mbs,
            "microblocks_per_bank": mb_banks,
            "inserted_txns": c["pack"]["inserted_txns"],
            "insert_rejected": c["pack"]["insert_rejected"],
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
            "recorded_selects_checked": min(len(calls), LEADER_RECORDED),
            # the block egress: the shred tile's slot finishes (shredding,
            # Merkle trees, Reed-Solomon) on its thread, and the checks
            "finish_slot_calls": len(host_s["finish_slot"]),
            "finish_slot_seconds": sum(host_s["finish_slot"]),
            "finish_slot_ms_per_slot": (sum(host_s["finish_slot"]) * 1e3
                                        / len(host_s["finish_slot"])
                                        if host_s["finish_slot"] else None),
            # the native stem's bursts on each tile's thread (pack's include
            # the native scheduler when the select is off)
            "stem_run_seconds": {n: sum(v) for n, v in stem_s.items() if v},
            "stem_run_calls": {n: len(v) for n, v in stem_s.items() if v},
            "stem_counts": stem_counts(r),
            **({"busy_share": share} if share is not None else {}),
            **({"wire": {k: r["wire"][k] for k in (
                "dgrams_sent", "net_rx_dgrams", "window", "rcvbuf", "handshake_ms",
                "quic_txns_per_s", "legacy_txns_per_s")}} if kind == "wire"
               else {}),
            "sha_launches_in_run": sha_launches, **egress})
    emit({"phase": "leader", "pool": TILES_POOL, "frags": LEADER_FRAGS, "lanes": B,
          "msg_width": W, "n_good": int(pool[2].sum()), "banks": 2, "checks": "exact",
          "transfer_pool": {"txns": TRANSFER_TXNS, "run_txns": TRANSFER_LEADER_TXNS,
                            "payers": TRANSFER_SIGNERS,
                            "seed": TRANSFER_SEED, "signing_seconds": sign_s},
          "runs": runs, "card": nvidia_smi_line(), "seconds": time.time() - t0})
    return first


# ---------------------------------------------------------------------------
# the validator: fdtctl's full topology from TOML, with funk-backed banks
# ---------------------------------------------------------------------------

#: the validator phase's transactions that go over QUIC (the rest go as
#: legacy datagrams), over this many connections
VALIDATOR_QUIC_TXNS, VALIDATOR_QUIC_CLIENTS = 128, 4
#: the validator phase's runs: (label, TOML added to the defaults); A is the
#: default TOML (Python loop, host select), B the native stem with pack's
#: select on the card, C A's TOML with one OS process per tile; each runs
#: profiled (disco/profile.py)
VALIDATOR_RUNS = (("A", ""),
                  ("B", '[topo]\nstem = "native"\n[tiles.pack]\ndevice_select = true\n'),
                  ("C", '[topo]\nruntime = "process"\n'))
#: the transfer corpus's first transactions each validator run sends (cut
#: from all 8,192 to pay for run C and the process tiles run; the same
#: 1,024 payers, the same pacing rule)
VALIDATOR_TXNS = 4096
#: lamports each payer holds beyond its transfers and their fees
VALIDATOR_MARGIN = 1_000_000
#: accounts whose balance RPC getBalance must report, and the seconds it may
#: take a housekeeping commit to land them in funk
VALIDATOR_RPC_SAMPLE, VALIDATOR_RPC_DEADLINE_S = 64, 60.0
#: the run loop's idle sleep in the validator runs
VALIDATOR_IDLE_S = 1e-3
#: the bank counters that the monitor, /metrics and topo.metrics must agree on
VALIDATOR_BANK_COUNTERS = ("executed_microblocks", "executed_txns", "failed_txns",
                           "fast_txns", "fees_lamports", "native_txns")
#: fdtctl's monitor prints in the CLI check
FDTCTL_ITERATIONS = 5


def transfer_ledger(raws, fee: int = 5000):
    """The plain reference of the validator phase, independent of
    flamenco/runtime.py: each transfer's payer (account 0), destination
    (account 1) and amount (the system instruction's u64 after its u32
    tag) read from the wire bytes; -> (funding: payer -> lamports, enough
    for all its transfers and fees plus VALIDATOR_MARGIN; want: account ->
    lamports once every transfer executed)."""
    from firedancer_tpu_torch.ballet import txn as T

    spend, credit = {}, {}
    for raw in raws:
        d = T.parse(raw)
        payer, dest = bytes(d.acct_addr(raw, 0)), bytes(d.acct_addr(raw, 1))
        off = d.instr[0].data_off
        if int.from_bytes(raw[off:off + 4], "little") != 2:
            raise AssertionError("the validator corpus holds a non-transfer")
        amount = int.from_bytes(raw[off + 4:off + 12], "little")
        spend[payer] = spend.get(payer, 0) + amount + fee * d.signature_cnt
        credit[dest] = credit.get(dest, 0) + amount
    funding = {p: s + VALIDATOR_MARGIN for p, s in spend.items()}
    want = {p: funding[p] - spend[p] for p in funding}
    for k, v in credit.items():
        want[k] = want.get(k, 0) + v
    return funding, want


def validator_toml(name: str, ports: dict, extra: str = "") -> str:
    """The validator's TOML: the repo's defaults (firedancer_tpu_torch/
    app/config.py) with the workspace name, the loopback ports and
    `extra` set."""
    return (f'name = "{name}"\n{extra}'
            f'[tiles.quic]\nquic_port = {ports["quic"]}\nudp_port = {ports["udp"]}\n'
            f'[tiles.metric]\nport = {ports["metric"]}\n'
            f'[tiles.rpc]\nport = {ports["rpc"]}\n')


def free_ports(n: int) -> list:
    """n distinct free TCP/UDP port numbers on this host."""
    out = []
    while len(out) < n:
        p = free_port()
        if p not in out:
            out.append(p)
    return out


def _loopback(addr) -> tuple:
    return ("127.0.0.1", addr[1])


def validator_run(text: str, raws: list, funding: dict, identity: bytes, *,
                  device=None, idle_sleep_s: float = VALIDATOR_IDLE_S,
                  rpc_sample: list = (), want: dict | None = None,
                  quic_txns: int = VALIDATOR_QUIC_TXNS,
                  quic_clients: int = VALIDATOR_QUIC_CLIENTS,
                  profile: bool = False) -> dict:
    """One validator run: app.config.parse(text) ->
    build_validator_topology(cfg, identity, a temporary blockstore,
    funk=a fresh Funk holding `funding`, device=device), with a recording
    sink beside the PoH tile on each bank's ring; the last `quic_txns` of
    `raws` over `quic_clients` QUIC connections from a spawned child, the
    rest as legacy datagrams (a UdpBlaster), paced so that at most pack's
    depth less the banks' in-flight txns are sent and not yet executed;
    run until every txn is executed and mixed and the slot holding the
    last mixin is stored.  While the topology runs it asks RPC for the
    transaction count, the slot, the identity and the balance of each
    account of `rpc_sample` (polled until it equals `want`, or
    VALIDATOR_RPC_DEADLINE_S), scrapes /metrics and attaches a Monitor by
    the workspace's name.  -> a report with entry.leader's keys that
    check_egress reads, plus `rpc`, `scrape`, `monitor`, `funk` (every
    record after the halt), `banktab` (each `want` account's lamports in
    the banks' shared account table after the halt, None where absent)
    and the run's rates.

    Under `[topo] runtime = "process"` every tile but metric and rpc is
    a child process: the net child binds the TOML's ports, the sinks log
    their microblocks' SHA-256 in shm (tiles/sink.py shm_hash: the
    report's `microblock_payloads` is None and `microblock_sha256` holds
    the digests), the poh slot is read from its metrics, the shred tile's
    queues stay in its child (`shred_tile` None), `children` holds each
    child's Topology.tile_device (its CUDA context, its kernels'
    launches), and the bank children execute against pickled copies of
    `funk`, so RPC getBalance (the parent's funk) is asked once, not
    polled (ROADMAP C-8).  On the card it also gives `apps_before`
    (nvidia-smi's compute apps once the topology is built, before start)
    and `compute_apps` (the same while it runs).  profile:
    enable_profile(), the report's `profile` (disco/profile.aggregate, the
    rows, the cores) and `monitor_profile`, the profile rows a Monitor
    shows from a third process (`python -m firedancer_tpu_torch.app.monitor
    NAME --once --json`).  `verify_pid` is topo.tile_pid of the first
    verify tile."""
    import shutil
    import tempfile

    import torch

    from firedancer_tpu_torch.app import config as C
    from firedancer_tpu_torch.app.monitor import Monitor
    from firedancer_tpu_torch.ballet import base58, http
    from firedancer_tpu_torch.disco import metrics as M
    from firedancer_tpu_torch.disco import profile as PF
    from firedancer_tpu_torch.entry import WIRE_STALL_S, _stem_report
    from firedancer_tpu_torch.flamenco.accounts import Account, AccountMgr
    from firedancer_tpu_torch.flamenco.runtime import BankTable
    from firedancer_tpu_torch.funk import Funk
    from firedancer_tpu_torch.ops.ed25519 import hostpath
    from firedancer_tpu_torch.tiles.bench import BLAST_BURST, WireTraffic
    from firedancer_tpu_torch.tiles.rpc import rpc_call
    from firedancer_tpu_torch.tiles.sink import HASHLOG_ALLOC, SinkTile, read_hashlog
    from firedancer_tpu_torch.waltz.udpsock import UdpSock

    cfg = C.parse(text)
    proc = cfg.runtime == "process"
    want_apps = proc and torch.device(device or "cuda").type == "cuda"
    funk = Funk()
    mgr = AccountMgr(funk)
    for payer, lam in funding.items():
        mgr.store(payer, Account(lam))
    path = tempfile.mkdtemp(prefix="fdt_blockstore_")
    n_banks = cfg.bank_count
    legacy, quic = raws[:len(raws) - quic_txns], raws[len(raws) - quic_txns:]
    traffic = WireTraffic(legacy, quic, n_clients=quic_clients, seed=TILES_SEED)
    topo = None
    try:
        topo, h = C.build_validator_topology(cfg, identity, path, funk=funk,
                                             device=device)
        sinks = [SinkTile(record=not proc, shm_log=len(raws) if proc else 0,
                          shm_hash=proc, name=f"sink{i}") for i in range(n_banks)]
        for i, s in enumerate(sinks):
            topo.tile(s, ins=[(f"bank{i}_poh", True)])
        if profile:
            topo.enable_profile()
        topo.build()
        m = {n: topo.metrics(n) for n in topo.tiles}
        banks = [m[f"bank{i}"] for i in range(n_banks)]
        verify = [m[n] for n in topo.tiles if n.startswith("verify")]
        poh = topo.tiles["poh"].tile
        # the poh child's slot, from its metrics (the parent's tile copy
        # never runs)
        poh_slot = (lambda: m["poh"].counter("slots")) if proc else (lambda: poh.slot)
        budget = (cfg.pack_depth - n_banks * cfg.pack_mb_inflight * cfg.pack_txn_limit
                  - len(quic))
        if want_apps:
            marks_apps_before = compute_apps()
        t_boot = time.perf_counter()
        topo.start(batch_max=cfg.verify_max_lanes, idle_sleep_s=idle_sleep_s)
        boot_s = time.perf_counter() - t_boot
        import socket

        if proc:
            # the net child bound the TOML's ports; a probe socket set as
            # the net tile sets its own gives the granted SO_RCVBUF
            probe = UdpSock(("127.0.0.1", 0))
            rcvbuf = probe.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
            probe.close()
            addrs = {"quic": ("127.0.0.1", cfg.quic_port),
                     "udp": ("127.0.0.1", cfg.udp_port)}
        else:
            net = h["net"]
            rcvbuf = net.udp_sock.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF)
            addrs = {"quic": _loopback(net.quic_addr), "udp": _loopback(net.udp_addr)}
        t0 = time.perf_counter()
        traffic.start(addrs, rcvbuf)
        total, marks = len(raws), {}

        def executed() -> int:
            return sum(b.counter("executed_txns") for b in banks)

        def done() -> bool:
            mq = m["quic"]
            udp, qn = mq.counter("rx_txns_udp"), mq.counter("rx_txns_quic")
            traffic.poll(max(min(udp, executed() + budget - traffic.window - BLAST_BURST), 0))
            sent = traffic.dgrams_sent
            state = (sent["legacy"], m["net"].counter("rx_dgrams"), udp, qn, executed())
            now = time.perf_counter()
            if marks.get("state") != state:
                marks["state"], marks["moved"] = state, now
            elif now - marks["moved"] > WIRE_STALL_S:
                raise TimeoutError(f"validator stalled {WIRE_STALL_S} s: sent {sent}, "
                                   f"(legacy, net rx, udp, quic, executed) {state}")
            if not (traffic.finished() and m["net"].counter("rx_dgrams")
                    >= sent["legacy"] + sent["quic"] and udp + qn >= total):
                return False
            mp, md = m["pack"], m["dedup"]
            mbs = mp.counter("microblocks")
            mb_done = sum(b.counter("executed_microblocks") for b in banks)
            if not (sum(v.counter("in_frags") for v in verify) >= total
                    and md.counter("out_frags") + md.counter("dup_txns")
                    >= sum(v.counter("out_frags") for v in verify)
                    and mp.counter("inserted_txns") + mp.counter("insert_rejected")
                    >= md.counter("out_frags")
                    and mp.counter("microblock_txns") >= mp.counter("inserted_txns")
                    and mp.counter("completions") >= mbs
                    and mb_done + sum(b.counter("malformed_microblocks") for b in banks)
                    >= mbs
                    and sum(m[s.name].counter("sunk_frags") for s in sinks) >= mb_done
                    and executed() >= total):
                return False
            marks.setdefault("executed", now)
            if want_apps and "compute_apps" not in marks:
                marks["compute_apps"] = compute_apps()
            if m["poh"].counter("mixins") < mb_done:
                return False
            last = marks.setdefault("slot", poh_slot())
            return poh_slot() > last and m["store"].counter("completed_slots") >= last + 1

        deadline = t0 + 600.0
        while not done():
            topo.poll_failure()
            if time.perf_counter() > deadline:
                raise TimeoutError("validator: not done after 600 s")
            time.sleep(1e-3)
        dt = time.perf_counter() - t0
        # the observer surfaces, while every tile still runs
        rpc_addr, metric_addr = _loopback(h["rpc"].addr), _loopback(h["metric"].addr)
        rpc = {"getTransactionCount": rpc_call(rpc_addr, "getTransactionCount")["result"],
               "getSlot": rpc_call(rpc_addr, "getSlot")["result"],
               "getHealth": rpc_call(rpc_addr, "getHealth")["result"],
               "getIdentity": rpc_call(rpc_addr, "getIdentity")["result"]["identity"]}
        t_bal = time.perf_counter()
        balances = {}
        while True:
            balances = {k: rpc_call(rpc_addr, "getBalance", [base58.encode_32(k)])
                        ["result"]["value"] for k in rpc_sample}
            if want is None or all(balances[k] == want[k] for k in rpc_sample):
                break
            # the process runtime's banks write their own funk copies:
            # the parent's answer never moves (ROADMAP C-8)
            if proc or time.perf_counter() - t_bal > VALIDATOR_RPC_DEADLINE_S:
                break
            time.sleep(0.05)
        rpc["getBalance"] = balances
        rpc["balance_seconds"] = time.perf_counter() - t_bal
        status, body = http.get(metric_addr, "/metrics")
        scrape = {"status": status, "counters": {}}
        for line in body.decode().splitlines():
            if line.startswith("fdt_bank") and not line.startswith("#"):
                key, val = line.rsplit(" ", 1)
                scrape["counters"][key] = int(val)
        mon = Monitor(cfg.name)
        try:
            snap = mon.snapshot()
        finally:
            mon.wksp.close()
        monitor_profile = None
        if profile:
            out = subprocess.run(
                [sys.executable, "-m", "firedancer_tpu_torch.app.monitor", cfg.name,
                 "--once", "--json"], cwd=ROOT, capture_output=True, text=True,
                timeout=120)
            if out.returncode != 0:
                raise AssertionError(f"monitor from a third process exited "
                                     f"{out.returncode}: {out.stderr[-2000:]}")
            monitor_profile = {n: t.get("profile")
                               for n, t in json.loads(out.stdout)["tiles"].items()}
        monitor = {f"bank{i}": {c: snap[f"bank{i}"]["counters"][c]
                                for c in VALIDATOR_BANK_COUNTERS} for i in range(n_banks)}
        direct = {f"bank{i}": {c: banks[i].counter(c) for c in VALIDATOR_BANK_COUNTERS}
                  for i in range(n_banks)}
        verify_pid = topo.tile_pid(next(n for n in topo.tiles if n.startswith("verify")))
        topo.halt()
        topo.poll_failure()
        counters = {n: {c: mm.counter(c) for c in mm.schema.counters} for n, mm in m.items()}
        prof = None
        if profile:
            pm = topo.profile_metrics()
            prof = {**PF.aggregate(pm), "rows": PF.render_rows(pm),
                    "cores": len(os.sched_getaffinity(0))}
        mb_sha256 = ([h for s in sinks
                      for h in read_hashlog(topo.tile_alloc_view(s.name, HASHLOG_ALLOC))]
                     if proc else None)
        children = {n: d for n in topo.tiles if (d := topo.tile_device(n)) is not None}
        banktab = None
        if cfg.bank_native and want is not None:
            # the banks' shared account table, joined after the halt
            tab = BankTable(topo.wksp.view("shared_banktab"), cfg.bank_table_slots)
            banktab = {}
            for k in want:
                st, lam = tab.get(k)
                banktab[k] = lam if st == BankTable.ST_TRIVIAL else None
        lat = {}
        for i, s in enumerate(sinks):
            hh = m[s.name].hist(f"e2e_us_bank{i}_poh")
            if hh["count"]:
                lat[f"e2e_sink{i}_p50_us"] = M.hist_percentile(hh, 50)
                lat[f"e2e_sink{i}_p99_us"] = M.hist_percentile(hh, 99)
        hv = verify[0].hist("svc_us_quic_verify")
        if hv["count"]:
            lat["verify_hop_p99_us"] = M.hist_percentile(hv, 99)
        bs = h["store"].store
        stored = bs.slots()
        blockstore = {"blocks": {s: bs.block(s) for s in stored},
                      "shreds": {s: bs.shreds(s) for s in stored}}
        shred = None if proc else topo.tiles["shred"].tile
        wire_rep = traffic.report()
        stem_mode = cfg.stem or "python"
    finally:
        traffic.close()
        if topo is not None:
            topo.close()
        shutil.rmtree(path, ignore_errors=True)
    payloads = None if proc else [
        row[:sz].tobytes() for s in sinks
        for rows, szs in zip(s.payloads, s.sizes) for row, sz in zip(rows, szs)]
    seconds = marks["executed"] - t0
    return {
        "counters": counters, "microblock_payloads": payloads,
        "microblock_sha256": mb_sha256, "children": children,
        "blockstore": blockstore, "slots_mixed": marks["slot"] + 1,
        "identity": hostpath.public_from_secret(identity),
        "shred_tile": None if proc else {
            "pending": shred.pending_cnt, "signq": shred.signq_len,
            "outq": shred.outq_len},
        "stem": {"mode": stem_mode, "tiles": _stem_report(counters)},
        "runtime": "process" if proc else "thread",
        "rpc": rpc, "scrape": scrape, "monitor": monitor, "monitor_direct": direct,
        "monitor_profile": monitor_profile, "profile": prof,
        "apps_before": marks_apps_before if want_apps else None,
        "compute_apps": marks.get("compute_apps"), "verify_pid": verify_pid,
        "funk": dict(funk.root), "banktab": banktab, "total": total, "seconds": seconds,
        "boot_seconds": boot_s,
        "egress_seconds": dt, "executed_per_s": total / seconds, **lat,
        "wire": {"dgrams_sent": wire_rep["dgrams_sent"], "window": wire_rep["window"],
                 "rcvbuf": wire_rep["rcvbuf"], "handshake_ms": wire_rep["handshake_ms"],
                 "quic_clients": wire_rep["quic_clients"],
                 "net_rx_dgrams": counters["net"]["rx_dgrams"],
                 "oversize_drops": counters["net"]["oversize_drops"],
                 "rx_txns_udp": counters["quic"]["rx_txns_udp"],
                 "rx_txns_quic": counters["quic"]["rx_txns_quic"],
                 "conns_opened": counters["quic"]["conns_opened"],
                 "parse_fail_txns": counters["quic"]["parse_fail_txns"]},
    }


def compute_apps() -> list:
    """nvidia-smi's compute apps on the card: [pid, used memory] rows, one
    a process holding a CUDA context.  Inside a container nvidia-smi may
    report pids of another pid namespace (a spawned child of pid 120 was
    listed as pid 1), so a child shows as a row more, not by its pid."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        raise AssertionError(f"nvidia-smi --query-compute-apps exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    return [[int(ln.split(",")[0]), ln.split(",")[1].strip()]
            for ln in out.stdout.splitlines() if ln.strip()]


def check_validator(r, want: dict, n_legacy: int, identity_pub: bytes, *,
                    native: bool, launches: int | None = None,
                    all_banks_busy: bool = True) -> None:
    """A validator run's exact checks (all but the egress, which
    check_egress holds); raises on any miss.  all_banks_busy: every bank
    executed some txns (a corpus of a few batches may leave one idle).

    Every run: the banks' shared account table after the halt holds each
    ledger account's balance.  A thread run: funk after the halt too, and
    RPC getBalance.  A process run (r["runtime"]): funk and getBalance are
    the parent's, which no bank child writes (ROADMAP C-8), so neither is
    held; the table is the banks' state.  A profiled run: the Monitor of a
    third process shows every tile's profile row with samples.  launches:
    verify_core's in the process that ran the verify tile, one a batch
    and one warm-up (None: not held)."""
    from firedancer_tpu_torch.ballet import base58
    from firedancer_tpu_torch.flamenco import sysvar
    from firedancer_tpu_torch.flamenco.accounts import Account

    c, total = r["counters"], r["total"]
    banks = sorted(k for k in c if re.fullmatch(r"bank\d+", k))
    w = r["wire"]
    n_quic = sum(cl["txns"] for cl in w["quic_clients"])
    got = {"net_rx_dgrams": w["net_rx_dgrams"], "oversize_drops": w["oversize_drops"],
           "rx_txns_udp": w["rx_txns_udp"], "rx_txns_quic": w["rx_txns_quic"],
           "parse_fail_txns": w["parse_fail_txns"], "legacy_sent": w["dgrams_sent"]["legacy"]}
    wnt = {"net_rx_dgrams": w["dgrams_sent"]["legacy"] + w["dgrams_sent"]["quic"],
           "oversize_drops": 0, "rx_txns_udp": n_legacy, "rx_txns_quic": total - n_legacy,
           "parse_fail_txns": 0, "legacy_sent": n_legacy}
    if got != wnt or n_quic != total - n_legacy:
        raise AssertionError(f"validator wire counters {got} != {wnt} ({n_quic} QUIC txns)")
    bad = [cl for cl in w["quic_clients"]
           if not cl["established"] or cl["peer_identity"] != identity_pub]
    if bad:
        raise AssertionError(f"QUIC clients not established or with another peer: {bad}")
    vs = [k for k in c if k.startswith("verify")]
    v = {k: sum(c[n][k] for n in vs) for k in (
        "in_frags", "out_frags", "verify_fail_txns", "dedup_drop_txns", "device_batches",
        "fallback_batches", "device_errors", "device_trips")}
    p = c["pack"]
    got = {
        "verify_in": v["in_frags"], "verify_out": v["out_frags"],
        "verify_fail": v["verify_fail_txns"], "verify_dedup_drop": v["dedup_drop_txns"],
        "fallback_batches": v["fallback_batches"], "device_errors": v["device_errors"],
        "dedup_out": c["dedup"]["out_frags"], "dedup_dups": c["dedup"]["dup_txns"],
        "inserted_txns": p["inserted_txns"], "insert_rejected": p["insert_rejected"],
        "executed_txns": sum(c[b]["executed_txns"] for b in banks),
        "failed_txns": sum(c[b]["failed_txns"] for b in banks),
        "malformed_microblocks": sum(c[b]["malformed_microblocks"] for b in banks),
        "fees_lamports": sum(c[b]["fees_lamports"] for b in banks),
        "fast_txns" if not native else "native_txns":
            sum(c[b]["native_txns" if native else "fast_txns"] for b in banks),
        "completions": p["completions"],
    }
    wnt = {"verify_in": total, "verify_out": total, "verify_fail": 0,
           "verify_dedup_drop": 0, "fallback_batches": 0, "device_errors": 0,
           "dedup_out": total, "dedup_dups": 0, "inserted_txns": total,
           "insert_rejected": 0, "executed_txns": total, "failed_txns": 0,
           "malformed_microblocks": 0, "fees_lamports": 5000 * total,
           "fast_txns" if not native else "native_txns": total,
           "completions": p["microblocks"]}
    if got != wnt:
        raise AssertionError(f"validator counters {got} != {wnt}")
    idle = [b for b in banks if c[b]["executed_txns"] == 0]
    if idle and all_banks_busy:
        raise AssertionError(f"validator: {idle} executed nothing")
    if launches is not None and launches != v["device_batches"] + 1:
        raise AssertionError(f"verify_core launched {launches} times for "
                             f"{v['device_batches']} batches and one warm-up")
    tab = r["banktab"]
    tab_bad = [k for k, lam in want.items() if tab[k] != lam]
    if tab_bad:
        raise AssertionError(f"bank table: {len(tab_bad)} accounts differ from the ledger")
    proc = r["runtime"] == "process"
    rpc = r["rpc"]
    if not proc:
        # funk after the halt: every ledger account, and sysvars beside them
        f = r["funk"]
        wrong = [k for k, lam in want.items()
                 if k not in f or Account.decode(f[k]).lamports != lam]
        other = [k for k in f if k not in want
                 and Account.decode(f[k]).owner != sysvar.SYSVAR_OWNER_ID]
        if wrong or other:
            raise AssertionError(f"funk: {len(wrong)} accounts differ from the ledger, "
                                 f"{len(other)} accounts outside it")
    bal_bad = {} if proc else {k.hex(): (v_, want[k]) for k, v_ in rpc["getBalance"].items()
                               if v_ != want[k]}
    if (rpc["getTransactionCount"] != total or rpc["getSlot"] < 1 or rpc["getHealth"] != "ok"
            or rpc["getIdentity"] != base58.encode_32(identity_pub) or bal_bad):
        raise AssertionError(f"RPC: {dict(rpc, getBalance=bal_bad)}")
    sc = r["scrape"]
    execd = sum(sc["counters"].get(f"fdt_{b}_executed_txns", 0) for b in banks)
    if sc["status"] != 200 or execd != total:
        raise AssertionError(f"/metrics: status {sc['status']}, executed_txns {execd}")
    if r["monitor"] != r["monitor_direct"]:
        raise AssertionError(f"monitor {r['monitor']} != topo.metrics {r['monitor_direct']}")
    mp = r["monitor_profile"]
    if mp is not None and (set(mp) != set(c) or not all(
            row and row["samples"] > 0 for row in mp.values())):
        raise AssertionError(f"the third process's monitor shows no profile row "
                             f"with samples for {sorted(n for n in c if not (mp.get(n) or {}).get('samples'))}")
    if r["compute_apps"] is not None:
        # nvidia-smi's pids are another pid namespace's, so a child shows
        # as a row more: the rows the run added are at least one and at
        # most the children that published a CUDA context, the verify
        # child among them
        cuda = sorted(n for n, d in r["children"].items() if d["cuda"])
        new = len(r["compute_apps"]) - len(r["apps_before"])
        if vs[0] not in cuda or not 1 <= new <= len(cuda) or r["verify_pid"] is None:
            raise AssertionError(f"nvidia-smi lists compute apps {r['compute_apps']} "
                                 f"while the run's children ran, {r['apps_before']} "
                                 f"before; children with a CUDA context {cuda} "
                                 f"(verify pid {r['verify_pid']})")


def fdtctl_check(name: str) -> dict:
    """fdtctl as an operator runs it: `python -m
    firedancer_tpu_torch.app.fdtctl run --full --config <toml> --keyfile
    <k> --iterations FDTCTL_ITERATIONS` in a subprocess on fixed free
    ports; once its workspace is published, `fdtctl monitor --name <name>
    --iterations 1` in a second subprocess must exit 0 and print the bank
    rows, GET /metrics must give 200 and RPC getHealth must answer "ok";
    then run must exit 0 and leave no workspace file.  -> seconds."""
    import glob
    import tempfile

    from firedancer_tpu_torch.ballet import http
    from firedancer_tpu_torch.tango import rings as R
    from firedancer_tpu_torch.tiles.rpc import rpc_call

    t0 = time.time()
    quic, udp, met, rpc = free_ports(4)
    d = tempfile.mkdtemp(prefix="fdtctl_")
    cfg = os.path.join(d, "validator.toml")
    key = os.path.join(d, "identity.key")
    with open(cfg, "w") as f:
        f.write(validator_toml(name, {"quic": quic, "udp": udp, "metric": met, "rpc": rpc}))
    with open(key, "wb") as f:
        f.write(wire_identity())
    cmd = [sys.executable, "-m", "firedancer_tpu_torch.app.fdtctl"]
    run = subprocess.Popen(cmd + ["run", "--full", "--config", cfg, "--keyfile", key,
                                  "--iterations", str(FDTCTL_ITERATIONS),
                                  "--blockstore", os.path.join(d, "store")],
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    out = {}
    try:
        dir_file = f"{R.SHM_PREFIX}{name}.dir"
        deadline = time.time() + 300
        while not os.path.exists(dir_file):
            if run.poll() is not None or time.time() > deadline:
                raise AssertionError(f"fdtctl run published no workspace (exit "
                                     f"{run.poll()}): {run.stderr.read()[-4000:]}")
            time.sleep(0.05)
        out["boot_seconds"] = time.time() - t0
        mon = subprocess.Popen(cmd + ["monitor", "--name", name, "--iterations", "1"],
                               cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        status, body = http.get(("127.0.0.1", met), "/metrics")
        health = rpc_call(("127.0.0.1", rpc), "getHealth")["result"]
        m_out, m_err = mon.communicate(timeout=120)
        rows = [ln.split()[0] for ln in m_out.splitlines() if ln.split()[:1] in (["bank0"],
                                                                                ["bank1"])]
        if (mon.returncode != 0 or sorted(rows) != ["bank0", "bank1"] or status != 200
                or b"fdt_bank0_executed_txns" not in body or health != "ok"):
            raise AssertionError(f"fdtctl monitor exited {mon.returncode} with bank rows "
                                 f"{rows}; /metrics {status}; getHealth {health!r}: "
                                 f"{m_err[-2000:]}")
        r_out, r_err = run.communicate(timeout=300)
    finally:
        if run.poll() is None:
            run.kill()
            run.communicate()
    left = glob.glob(f"{R.SHM_PREFIX}{name}*")
    if run.returncode != 0 or left:
        raise AssertionError(f"fdtctl run exited {run.returncode}, left {left}: "
                             f"{r_err[-4000:]}")
    prints = len(re.findall(r"(?m)^\s*tile\s+state\s", r_out))
    out.update({"seconds": time.time() - t0, "monitor_prints": prints,
                "metrics_status": status, "get_health": health})
    return out


def phase_validator(dev) -> dict:
    """The validator as an operator boots it, on the card: runs A, B and C
    (VALIDATOR_RUNS; C one OS process per tile) of build_validator_topology
    from TOML with a funded Funk on the transfer corpus's first
    VALIDATOR_TXNS (of 8,192 distinct transfers over 1,024 payers, signed
    on the card), each profiled and held by check_validator, check_egress
    and, on B, check_stem; then fdtctl_check.  -> the launches of
    verify_core and pack_select in its runs (C's as its children
    published them)."""
    import glob

    from firedancer_tpu_torch import entry
    from firedancer_tpu_torch.flamenco.accounts import Account
    from firedancer_tpu_torch.ops import pack_select as PS
    from firedancer_tpu_torch.ops.ed25519 import hostpath
    from firedancer_tpu_torch.ops.ed25519 import verify_core as VC
    from firedancer_tpu_torch.tango import rings as R
    from firedancer_tpu_torch.tiles.shred import ShredTile

    t0 = time.time()
    tpool, sign_s = transfer_pool(dev)
    raws = entry.raw_txns(tpool)[:VALIDATOR_TXNS]
    funding, want = transfer_ledger(raws)
    identity = wire_identity()
    pub = hostpath.public_from_secret(identity)
    rng = np.random.default_rng(TRANSFER_SEED)
    keys = sorted(want)
    sample = [keys[i] for i in rng.choice(len(keys), VALIDATOR_RPC_SAMPLE, replace=False)]
    orig_sel, orig_finish, orig_stem_run = PS.select_noconflict, ShredTile._finish_slot, R.Stem.run
    runs, launches = [], {"verify_core": 0, "pack_select": 0}
    for label, extra in VALIDATOR_RUNS:
        calls, finish, stem_s = [0], [], {}

        def counting(*a, **kw):
            calls[0] += 1
            return orig_sel(*a, **kw)

        def timed_finish(self, *a, **kw):
            t = time.perf_counter()
            out = orig_finish(self, *a, **kw)
            finish.append(time.perf_counter() - t)
            return out

        def stem_run(self, *a, **kw):
            t = time.perf_counter()
            out = orig_stem_run(self, *a, **kw)
            h = self.spec.handler
            name = (f"bank{int(self.spec.args[22])}" if h == R.STEM_H_BANK
                    else STEM_HANDLER_TILES[h])
            stem_s[name] = stem_s.get(name, 0.0) + time.perf_counter() - t
            return out

        ports = dict(zip(("quic", "udp", "metric", "rpc"), free_ports(4)))
        # the pid keeps two scripts on one host out of each other's
        # workspaces and leftover checks
        name = f"fdt_smoke_{label.lower()}_{os.getpid()}"
        text = validator_toml(name, ports, extra)
        proc = "process" in extra
        PS.select_noconflict = counting
        ShredTile._finish_slot = timed_finish
        R.Stem.run = stem_run
        try:
            sync()
            VC.LAUNCHES = 0
            PS.LAUNCHES = 0
            r = validator_run(text, raws, funding, identity, device=dev,
                              rpc_sample=sample, want=want, profile=True)
            sync()
            vc, ps = VC.LAUNCHES, PS.LAUNCHES
        finally:
            PS.select_noconflict = orig_sel
            ShredTile._finish_slot = orig_finish
            R.Stem.run = orig_stem_run
        native = "native" in extra
        if proc:
            # a process run's kernels launch in its children, which
            # published their counts as they exited: none in this process
            if vc or ps:
                raise AssertionError(f"run {label}: verify_core launched {vc}, "
                                     f"pack_select {ps} times in the parent")
            vc = r["children"]["verify0"]["launches"]["verify_core"]
            ps = r["children"]["pack"]["launches"]["pack_select"]
        check_validator(r, want, len(raws) - VALIDATOR_QUIC_TXNS, pub, native=native,
                        launches=vc)
        left = glob.glob(f"{R.SHM_PREFIX}{name}*")
        if left:
            raise AssertionError(f"run {label} left {left}")
        if native:
            # every transfer has a destination no earlier one touched, so
            # every microblock misses the shared table and the bank
            # handler hands it back (fdt_bank_exec then runs it from the
            # Python resume: native_txns)
            check_stem(r, STEM_TILES["validator"], handback=("bank0", "bank1"))
            if not all(stem_s.get(b) for b in ("bank0", "bank1")):
                raise AssertionError(f"run {label}: the bank handler never ran: {stem_s}")
        if (ps != calls[0] and not proc) or (native and not calls[0]):
            raise AssertionError(f"pack_select launched {ps} times for {calls[0]} "
                                 f"select calls (run {label})")
        egress = check_egress(r, dev)
        c = r["counters"]
        launches["verify_core"] += vc
        launches["pack_select"] += ps
        runs.append({
            "run": label, "toml_extra": extra, "executed_per_s": r["executed_per_s"],
            "seconds": r["seconds"], "egress_seconds": r["egress_seconds"],
            **{k: v for k, v in r.items() if k.endswith("_us")},
            "runtime": r["runtime"], "boot_seconds": r["boot_seconds"],
            "device_batches": c["verify0"]["device_batches"],
            "verify_core_launches_after_warmup": vc - 1,
            "select_calls": None if proc else calls[0], "pack_select_launches": ps,
            "handshake_ms": r["wire"]["handshake_ms"],
            "finish_slot_ms_per_slot": (sum(finish) * 1e3 / len(finish) if finish else None),
            "committed_accounts": {b: c[b]["committed_accounts"] for b in ("bank0", "bank1")},
            "microblocks_per_bank": [c[b]["executed_microblocks"] for b in ("bank0", "bank1")],
            "fast_txns": sum(c[b]["fast_txns"] for b in ("bank0", "bank1")),
            "native_txns": sum(c[b]["native_txns"] for b in ("bank0", "bank1")),
            "rpc_balance_seconds": r["rpc"]["balance_seconds"],
            # C-8: the parent's funk after a process run (getBalance's
            # source), against the ledger
            "parent_funk_stale_accounts": (sum(
                1 for k, lam in want.items()
                if k not in r["funk"] or Account.decode(r["funk"][k]).lamports != lam)
                if proc else 0),
            "profile": profile_summary(r["profile"]),
            "apps_before": r["apps_before"], "compute_apps": r["compute_apps"],
            "verify_pid": r["verify_pid"],
            "children_with_cuda": sorted(n for n, d in r["children"].items() if d["cuda"]),
            "stem_run_seconds": stem_s, "stem_counts": stem_counts(r),
            "window": r["wire"]["window"], "rcvbuf": r["wire"]["rcvbuf"], **egress})
    cli = fdtctl_check(f"fdt_smoke_cli_{os.getpid()}")
    emit({"phase": "validator", "txns": len(raws), "payers": len(funding),
          "quic_txns": VALIDATOR_QUIC_TXNS, "accounts": len(want), "checks": "exact",
          "signing_seconds": sign_s, "runs": runs, "fdtctl": cli,
          "card": nvidia_smi_line(), "seconds": time.time() - t0})
    return launches


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


def run_multi(dev, batches, single_bloom, keeps, metrics, t_start) -> dict:
    """The phases of the multi-device layer and the tile pipelines; -> the
    leader's first run's kernel launches (phase_leader), with the wire
    runs' launches under "wire" and the validator runs' under
    "validator"."""
    phase_dist_step(dev, batches, single_bloom, keeps, metrics)
    phase_pool(dev, batches)
    pool, survivors = phase_tiles()
    wire_launches = phase_wire(pool, survivors)
    launches = phase_leader(dev, pool)
    launches["wire"]["verify_core_ingress"] = wire_launches["verify_core"]
    launches["validator"] = phase_validator(dev)
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
    phase_crossover(dev)
    phase_hmac(dev)
    leader_launches = run_multi(dev, batches, bloom, keeps, metrics, t_start)
    ps_row["launches"] = leader_launches["pack_select"]
    ps_row["wire_leader_launches"] = leader_launches["wire"]["pack_select"]
    ps_row["validator_launches"] = leader_launches["validator"]["pack_select"]
    for row in rest:
        row["leader_launches"] = leader_launches[row["name"]]

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
        **({"wire_launches": {
            "ingress": leader_launches["wire"]["verify_core_ingress"],
            "leader": leader_launches["wire"]["verify_core"]},
            "validator_launches": leader_launches["validator"]["verify_core"]}
           if name == "verify_core" else {}),
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
