"""Multi-rank dry run: the full pipeline step over a dp x mp mesh of ranks,
and the verify tile's device pool.

The counterpart of firedancer_tpu/parallel/dryrun.py.  Where the JAX dry run
shards one program over n virtual CPU devices, this one spawns n processes
(torch.multiprocessing, a FileStore in a temporary directory, one thread
each), joins them in one process group and builds the dp x mp groups of
parallel/mesh.py.  On cards (the default) the group is NCCL with rank r on
card r; NCCL refuses two ranks on one card, so n ranks need n cards.  With
device="cpu" the ranks are gloo ranks on the CPU, any number of them.

The rank functions live here, not in a test file: spawned children import
them by name, and a test module would drag JAX in with its imports.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from ..models import pipeline
from ..ops.ed25519 import hostpath
from ..ops.ed25519 import verify as fver
from ..tiles.verify import DevicePolicy, _DevicePool
from ..utils import devices
from .mesh import init_mesh


def _mesh_axes(n: int):
    """Factor n into (dp, mp): data-parallel lanes x model/table-parallel."""
    mp = 2 if n % 2 == 0 and n > 1 else 1
    return n // mp, mp


def _spawn(fn, n: int, *args) -> None:
    """Run fn(rank, n, store_path, *args) in n spawned processes, which join
    one group through the FileStore at store_path; raises if any rank fails.
    Every process has ended when this returns."""
    with tempfile.TemporaryDirectory() as d:
        torch_mp.spawn(fn, args=(n, os.path.join(d, "store"), *args), nprocs=n,
                  join=True)


def _join(rank: int, n: int, store_path: str, device_type: str):
    """Join the group: NCCL with this rank on card `rank`, or gloo on the
    CPU; -> this rank's device."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    return dev


def _check_cards(dev, n: int) -> None:
    """NCCL refuses two ranks on one card: n CUDA ranks need n cards."""
    cards = devices.local_device_count(default=0)
    if dev.type == "cuda" and n > cards:
        raise ValueError(f"{n} NCCL ranks need {n} cards and this host has "
                         f"{cards}; device='cpu' runs them as gloo ranks")


def _dryrun_rank(rank, n, store_path, dp, mp, device_type):
    dev = _join(rank, n, store_path, device_type)
    try:
        mesh = init_mesh(dp, mp)
        batch, msg_len = 8 * dp, 64
        rng = np.random.default_rng(0)
        msgs = rng.integers(0, 256, size=(batch, msg_len), dtype=np.uint8)
        lens = np.full((batch,), msg_len, dtype=np.int32)
        pipeline.dryrun_step(mesh, msgs, lens, device=dev)
        # multi-step sustained run: aging-bloom rotation boundaries,
        # per-step metrics consistency, uneven final dp batch
        rotations = pipeline.dryrun_sustained(mesh, device=dev)
        if rank == 0:
            print(f"dryrun_sustained ok: 6 steps, rotations={rotations}",
                  flush=True)
    finally:
        dist.destroy_process_group()


def run(n_devices: int, device=None) -> None:
    """The dry run on n ranks (dp x mp from _mesh_axes): one step and the
    sustained run at B = 8 * dp lanes of 64 bytes, then the device pool over
    two domains (one when n is 1).  device=None: NCCL ranks on the first n
    cards and CUDA pool domains; raises when the host has fewer than n
    cards.  device="cpu": gloo ranks and CPU pool domains."""
    dev = devices.resolve(device)
    _check_cards(dev, n_devices)
    dp, mp = _mesh_axes(n_devices)
    _spawn(_dryrun_rank, n_devices, dp, mp, dev.type)
    run_verify_pool(min(2, n_devices), device=dev)
    print(f"dryrun_multichip ok: full pipeline on mesh dp={dp} mp={mp}")


# ---------------------------------------------------------------------------
# steps over a mesh, for comparing the ranks' outputs with a reference
# ---------------------------------------------------------------------------


def _steps_rank(rank, n, store_path, dp, mp, device_type, case_path, out_dir):
    dev = _join(rank, n, store_path, device_type)
    try:
        mesh = init_mesh(dp, mp)
        case = dict(np.load(case_path))
        sl = pipeline._dp_slice(mesh, int(case["lanes"]))
        step = pipeline.make_step(dev, mesh)
        bloom = pipeline.AgingBloom(dev, int(case["capacity"]), mp)
        out = {}
        for i in range(int(case["steps"])):
            b = {k[len(f"{i}_"):]: v[sl] for k, v in case.items()
                 if k.startswith(f"{i}_")}
            tags2 = torch.from_numpy(b["tags2"].astype(np.int64)).to(dev)
            for run in range(1 + int(case["repeat"])):
                if "ok" in b:  # the dedup half alone, on given verdicts
                    res = pipeline.dedup(torch.from_numpy(b["ok"]).to(dev),
                                         tags2, *bloom.buffers(), mesh)
                else:
                    res = step(b["msgs"], b["lens"], b["sigs"], b["pubs"],
                               tags2, *bloom.buffers())
                for key, t in zip(("keep", "cur", "metrics"), res):
                    out[f"{i}_{run}_{key}"] = t.cpu().numpy().copy()
            bloom.update(res[1], res[2])
            out[f"{i}_state"] = np.concatenate(
                [bloom.cur.cpu().numpy(), bloom.prev.cpu().numpy()])
            out[f"{i}_counts"] = np.array([bloom.inserted, bloom.rotations])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_steps(dp: int, mp: int, batches: list, capacity: int = pipeline.AGE_CAPACITY,
              repeat: bool = False, device=None) -> list:
    """Run `batches` in order through the step on dp x mp ranks (NCCL on
    the first dp * mp cards, or gloo with device="cpu"), each starting from
    an empty AgingBloom(capacity) shard, updated after every batch.

    A batch is a dict of whole-batch numpy arrays: msgs, lens, sigs, pubs,
    tags2 (the full step) or ok, tags2 (the dedup half alone).  With
    `repeat` each batch runs twice on the same buffers before the update.
    -> per rank, per batch: {"keep": [...], "metrics": [...], "cur": [...]}
    (one entry per run; keep is the rank's dp slice, cur its new current
    shard), "cur_after"/"prev_after" (the shard pair after the update),
    "inserted", "rotations"."""
    case = {"lanes": len(batches[0]["tags2"]), "capacity": capacity,
            "steps": len(batches), "repeat": int(repeat)}
    for i, b in enumerate(batches):
        case.update({f"{i}_{k}": np.asarray(v) for k, v in b.items()})
    n = dp * mp
    dev = devices.resolve(device)
    _check_cards(dev, n)
    with tempfile.TemporaryDirectory() as d:
        np.savez(os.path.join(d, "case.npz"), **case)
        _spawn(_steps_rank, n, dp, mp, dev.type, os.path.join(d, "case.npz"), d)
        outs = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)]
    runs = range(1 + int(repeat))
    result = []
    for o in outs:
        per = []
        for i in range(len(batches)):
            words = o[f"{i}_state"].shape[0] // 2
            per.append({
                **{key: [o[f"{i}_{r}_{key}"] for r in runs]
                   for key in ("keep", "metrics", "cur")},
                "cur_after": o[f"{i}_state"][:words],
                "prev_after": o[f"{i}_state"][words:],
                "inserted": int(o[f"{i}_counts"][0]),
                "rotations": int(o[f"{i}_counts"][1]),
            })
        result.append(per)
    return result


# ---------------------------------------------------------------------------
# the verify tile's device pool
# ---------------------------------------------------------------------------


def signed_digest_batch(lanes: int, seed: int = 2):
    """(digests, sigs, pubs): `lanes` valid signatures under one key, with
    digest = SHA512(R || A || M) computed on the host."""
    rng = np.random.default_rng(seed)
    sk = rng.integers(0, 256, 32, np.uint8).tobytes()
    pk = hostpath.public_from_secret(sk)
    digests = np.zeros((lanes, 64), np.uint8)
    sigs = np.zeros((lanes, 64), np.uint8)
    pubs = np.tile(np.frombuffer(pk, np.uint8), (lanes, 1))
    for i in range(lanes):
        msg = rng.integers(0, 256, 32, np.uint8).tobytes()
        sig = hostpath.sign(sk, msg)
        sigs[i] = np.frombuffer(sig, np.uint8)
        digests[i] = np.frombuffer(
            hashlib.sha512(sig[:32] + pk + msg).digest(), np.uint8)
    return digests, sigs, pubs


def drive_pool(pool, batches: list, timeout_s: float = 600.0) -> list:
    """Submit every (digests, sigs, pubs) batch through `pool` and poll
    until all have landed; -> their verdicts, in submission order.  Raises
    if they land out of order or not within timeout_s."""
    submitted = 0
    landed = []
    deadline = time.monotonic() + timeout_s
    while len(landed) < len(batches) and time.monotonic() < deadline:
        while submitted < len(batches) and pool.submit(
            {"lanes": len(batches[submitted][1]), "i": submitted},
            batches[submitted],
        ):
            submitted += 1
        pool.poll()
        while pool.ready:
            landed.append(pool.ready.popleft())
        time.sleep(0.001)
    order = [meta["i"] for meta, _ in landed]
    if order != list(range(len(batches))):
        raise AssertionError(f"pool landing out of order or incomplete: {order}")
    return [ok for _, ok in landed]


def domain_fns(n_devices: int, device=None, sample=None) -> list:
    """One verify_batch_digest_on per pool domain (CUDA ordinal i mod the
    card count, or the CPU for device="cpu"), each warmed on `sample` (a
    (digests, sigs, pubs) batch) as the verify tile warms its domains
    before the pool boots: a cold build in a worker's first dispatch would
    count against its stall patience."""
    dev = devices.resolve(device)
    if dev.type == "cuda":
        cards = devices.local_device_count()
        doms = [torch.device("cuda", i % cards) for i in range(n_devices)]
    else:
        doms = [dev] * n_devices
    fns = [fver.verify_batch_digest_on(d) for d in doms]
    if sample is not None:
        for fn in fns:
            fn(*sample).cpu()
    return fns


def run_verify_pool(n_devices: int, lanes: int = 16, device=None,
                    batches: list | None = None, fault_hook=None, fns=None,
                    **policy_kw) -> dict:
    """The verify tile's device pool over n_devices domains: domain_fns'
    warmed functions (or `fns`, warmed by the caller), a DevicePolicy fault
    domain each, and the batches submitted through the least-in-flight
    scheduler.  CPU domains keep the strict host path as their last
    resort; CUDA domains have none, and the pool raises DomainsOut when
    every one of them is out.

    `batches` defaults to 2 * n_devices copies of one batch of `lanes`
    valid signatures, which must all verify; landing must be in order.
    fault_hook and policy_kw go to every DevicePolicy.  -> {"verdicts",
    "seconds" (first submit to last landing), and the pool's counters
    (_DevicePool.counters)}."""
    dev = devices.resolve(device)
    default = batches is None
    if default:
        batches = [signed_digest_batch(lanes)] * (2 * n_devices)
    if fns is None:
        fns = domain_fns(n_devices, dev, batches[0])
    host = None if dev.type == "cuda" else hostpath.verify_batch_digest_host
    policies = [
        DevicePolicy(fn, host, index=i, fault_hook=fault_hook, **policy_kw)
        for i, fn in enumerate(fns)
    ]
    pool = _DevicePool(policies, depth=2, name="dryrun")
    try:
        t0 = time.monotonic()
        verdicts = drive_pool(pool, batches)
        seconds = time.monotonic() - t0
    finally:
        pool.stop(timeout_s=30.0)
    counters = pool.counters()
    if default:
        if not all(ok[:lanes].all() for ok in verdicts):
            raise AssertionError("pool verify rejected valid signatures")
        used = sum(1 for n in counters["landed"] if n > 0)
        if used < min(2, len(fns)):
            raise AssertionError(f"pool did not spread work: {counters['landed']}")
        print(f"dryrun_verify_pool ok: {len(batches)} batches in order over "
              f"{used}/{len(fns)} domains")
    return {"verdicts": verdicts, "seconds": seconds, **counters}
