"""Headline benchmark of the port: Ed25519 verifies/s on the CUDA card(s),
and the verify path's txns/s through the tile pipeline.

    python -m firedancer_tpu_torch.bench [--lanes 4096] [--msg-len 1232]
    python -m firedancer_tpu_torch.bench --mode pipeline [--idle-sleep-us 50]

Prints exactly one JSON line:

  {"metric": "ed25519_verifies_per_s_1chip", "value": N, "unit": "verify/s",
   "n_devices": 1, "per_device": [N], "digest_form": {...}, ...}

The counterpart of bench.py's `_bench_verify`, with the same keys.  `value`
is the message form (`verify_batch`: SHA-512 on the card), the rate of the
JAX bench's kernel metric; `digest_form` gives the same numbers for
`verify_batch_digest`, the verify tile's device call (SHA-512 done on the
host).  The batch is B = 4096 lanes of 1232-byte messages (the verify
tile's max_lanes and Solana's packet limit), not the JAX bench's 524,288
lanes: the port's SHA-512 is plain torch, and such a batch would run for
minutes.

Each card gets its own device-resident input sets, each of 64 distinct
signed messages repeated to fill the batch: set 0 warms up (builds the
kernels) and is checked to verify; sets 1-3 are timed one call each with
CUDA events, and the best counts.  On N cards the aggregate round launches
one batch on every card, then syncs them all (host clock, sets 4-6, never
run before), and the metric becomes ed25519_verifies_per_s_<N>chip with
the 1chip key carrying value / N, as bench.py aggregates.

`--device cpu` runs the plain versions on the CPU at a small --lanes (a
smoke run of the script); its metric is ed25519_verifies_per_s_cpu and
its times are host-clock times of the CPU.

`--mode pipeline` is the counterpart of bench.py's `_bench_pipeline_tps`,
with its topology, sizes and keys: a 256-txn pool (seed 7) written to a
pcap, replayed 1 << 20 times by the replay tile -> verify (msg_width 256,
max_lanes 16384, pad_full, no pre-dedup; on the card) -> dedup (depth
1 << 20) -> sink over rings of depth 1 << 15, batch_max 16384.  It prints
one JSON line: {"metric": "verify_path_tps", "value": txns/s, "unit":
"txn/s", "verify_path_tps", "e2e_p50_us", "e2e_p99_us",
"verify_hop_p99_us", ...}; txns/s counts the frags the dedup tile took in
over the wall time, the latencies come from the run loop's link hists
(e2e at the sink's in-link, the verify tile's per-batch service time).
--idle-sleep-us is the run loop's idle sleep (50 µs, its default, as in
bench.py).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from .ops.ed25519 import hostpath
from .ops.ed25519 import verify as fver
from .utils import devices

#: distinct signed messages per input set (bench.py's n_real)
N_REAL = 64


def make_inputs(rng, lanes: int, msg_len: int):
    """-> (msgs, lens, sigs, pubs, digests): N_REAL distinct messages
    signed under one key, repeated to fill `lanes`."""
    secret = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    pub = hostpath.public_from_secret(secret)
    msgs = np.zeros((lanes, msg_len), np.uint8)
    sigs = np.zeros((lanes, 64), np.uint8)
    digests = np.zeros((lanes, 64), np.uint8)
    lens = np.full(lanes, msg_len, np.int32)
    pubs = np.tile(np.frombuffer(pub, np.uint8), (lanes, 1))
    for i in range(min(N_REAL, lanes)):
        m = rng.integers(0, 256, msg_len, dtype=np.uint8)
        s = hostpath.sign(secret, m.tobytes())
        msgs[i::N_REAL] = m
        sigs[i::N_REAL] = np.frombuffer(s, np.uint8)
        digests[i::N_REAL] = np.frombuffer(
            hashlib.sha512(s[:32] + pub + m.tobytes()).digest(), np.uint8)
    return msgs, lens, sigs, pubs, digests


def _forms(dev):
    """name -> (function on device-resident tensors, its argument picker)."""
    return {
        "message": lambda m, l, s, p, d: fver.verify_batch(m, l, s, p, device=dev),
        "digest": lambda m, l, s, p, d: fver.verify_batch_digest(d, s, p, device=dev),
    }


def _call_ms(fn, args, dev) -> float:
    """One call's time in ms: CUDA events on a card, the host clock on the
    CPU; the result is consumed inside the timed region."""
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn(*args)
            e1.record()
            e1.synchronize()
            return e0.elapsed_time(e1)
    t0 = time.perf_counter()
    fn(*args)
    return (time.perf_counter() - t0) * 1e3


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def bench(lanes: int = 4096, msg_len: int = 1232, device=None) -> dict:
    dev = devices.resolve(device)
    devs = ([torch.device("cuda", i) for i in range(devices.local_device_count())]
            if dev.type == "cuda" else [dev])
    n_dev = len(devs)
    rng = np.random.default_rng(42)
    n_sets = 4 if n_dev == 1 else 7
    dev_sets = []
    for d in devs:
        sets = []
        for _ in range(n_sets):
            msgs, lens, sigs, pubs, digests = make_inputs(rng, lanes, msg_len)
            sets.append((
                devices.as_tensor(msgs, torch.uint8, d),
                devices.as_tensor(lens, torch.int64, d),
                devices.as_tensor(sigs, torch.uint8, d),
                devices.as_tensor(pubs, torch.uint8, d),
                devices.as_tensor(digests, torch.uint8, d),
            ))
        dev_sets.append(sets)

    out = {}
    for form in ("message", "digest"):
        per_device = []
        for d, sets in zip(devs, dev_sets):
            fn = _forms(d)[form]
            if not bool(fn(*sets[0]).all()):  # warm-up and correctness gate
                raise AssertionError(f"{form} form rejected valid signatures")
            best = min(_call_ms(fn, s, d) for s in sets[1:4])
            per_device.append(lanes / best * 1e3)
        out[form] = {"per_device": per_device, "value": per_device[0]}
        if n_dev > 1:
            # one batch in flight on every card, then sync them all
            best = float("inf")
            for r in range(4, 7):
                t0 = time.perf_counter()
                res = [_forms(d)[form](*sets[r]) for d, sets in zip(devs, dev_sets)]
                for o in res:
                    o.cpu()
                best = min(best, time.perf_counter() - t0)
            out[form]["value"] = n_dev * lanes / best

    name = "cpu" if dev.type == "cpu" else f"{n_dev}chip"
    result = {
        "metric": f"ed25519_verifies_per_s_{name}",
        "value": out["message"]["value"],
        "unit": "verify/s",
        "n_devices": n_dev,
        "per_device": out["message"]["per_device"],
        "digest_form": {"metric": f"ed25519_digest_verifies_per_s_{name}",
                        **out["digest"]},
        "lanes": lanes,
        "msg_len": msg_len,
        "device": _device_name(devs[0]),
    }
    if n_dev > 1:
        result["ed25519_verifies_per_s_1chip"] = result["value"] / n_dev
    return result


#: bench.py's pipeline sizes
PIPE_POOL, PIPE_TOTAL, PIPE_LANES, PIPE_MSG_WIDTH = 256, 1 << 20, 16384, 256


def pipeline(total: int = PIPE_TOTAL, idle_sleep_s: float = 50e-6,
             device=None) -> dict:
    """Replay -> verify -> dedup -> sink over real rings; -> the JSON
    line's dict (see the module docstring)."""
    import os
    import tempfile

    from .disco import metrics as M
    from .disco.topo import Topology
    from .tiles import wire
    from .tiles.dedup import DedupTile
    from .tiles.replay import ReplayTile
    from .tiles.sink import SinkTile
    from .tiles.synth import make_txn_pool
    from .tiles.verify import VerifyTile
    from .waltz import pcap

    verify = VerifyTile(msg_width=PIPE_MSG_WIDTH, max_lanes=PIPE_LANES,
                        pad_full=True, pre_dedup=False, device=device)
    rows, szs, _good = make_txn_pool(PIPE_POOL, seed=7)
    # under the working directory, as bench.py does
    fd, path = tempfile.mkstemp(suffix=".pcap", dir=os.getcwd())
    os.close(fd)
    topo = Topology()
    try:
        w = pcap.PcapWriter(path)
        tr = wire.parse_trailers(rows, szs.astype(np.int64))
        for i in range(PIPE_POOL):
            w.write(rows[i, : tr["txn_sz"][i]].tobytes(), ts_us=i)
        w.close()
        for ln in ("replay_verify", "verify_dedup", "dedup_sink"):
            topo.link(ln, depth=1 << 15, mtu=wire.LINK_MTU)
        topo.tile(ReplayTile(path, total=total), outs=["replay_verify"])
        topo.tile(verify, ins=[("replay_verify", True)], outs=["verify_dedup"])
        topo.tile(DedupTile(depth=1 << 20), ins=[("verify_dedup", True)],
                  outs=["dedup_sink"])
        topo.tile(SinkTile(), ins=[("dedup_sink", True)])
        topo.start(batch_max=PIPE_LANES, idle_sleep_s=idle_sleep_s)
        t0 = time.perf_counter()
        deadline = t0 + 600.0
        md = topo.metrics("dedup")
        while md.counter("in_frags") < total:
            topo.poll_failure()
            if time.perf_counter() > deadline:
                raise TimeoutError("pipeline bench: not done after 600 s")
            time.sleep(0.01)
        dt = time.perf_counter() - t0
        done = md.counter("in_frags")
        topo.halt()
        topo.poll_failure()
        out = {"metric": "verify_path_tps", "value": done / dt, "unit": "txn/s",
               "verify_path_tps": done / dt}
        he = topo.metrics("sink").hist("e2e_us_dedup_sink")
        if he["count"]:
            out["e2e_p50_us"] = M.hist_percentile(he, 50)
            out["e2e_p99_us"] = M.hist_percentile(he, 99)
        hv = topo.metrics("verify").hist("svc_us_replay_verify")
        if hv["count"]:
            out["verify_hop_p99_us"] = M.hist_percentile(hv, 99)
        mv = topo.metrics("verify")
        out.update({
            "frags": done, "seconds": dt, "lanes": PIPE_LANES,
            "msg_width": PIPE_MSG_WIDTH, "idle_sleep_us": idle_sleep_s * 1e6,
            "device_batches": mv.counter("device_batches"),
            "fallback_batches": mv.counter("fallback_batches"),
            "device": ("off" if device == "off" else
                       _device_name(devices.resolve(device))),
        })
        return out
    finally:
        topo.close()
        os.unlink(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("verify", "pipeline"), default="verify")
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--msg-len", type=int, default=1232)
    ap.add_argument("--total", type=int, default=PIPE_TOTAL,
                    help="pipeline: frags replayed (fewer for a CPU run)")
    ap.add_argument("--idle-sleep-us", type=float, default=50.0,
                    help="pipeline: the run loop's idle sleep")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cpu (the plain versions); "
                         "pipeline also: off (the strict host path)")
    args = ap.parse_args(argv)
    if args.mode == "pipeline":
        out = pipeline(args.total, args.idle_sleep_us * 1e-6, args.device)
    else:
        out = bench(args.lanes, args.msg_len, args.device)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
