"""Headline benchmark of the port: Ed25519 verifies/s on the CUDA card(s).

    python -m firedancer_tpu_torch.bench [--lanes 4096] [--msg-len 1232]

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
        "device": (torch.cuda.get_device_name(devs[0]) if dev.type == "cuda"
                   else "cpu"),
    }
    if n_dev > 1:
        result["ed25519_verifies_per_s_1chip"] = result["value"] / n_dev
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--msg-len", type=int, default=1232)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.lanes, args.msg_len, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
