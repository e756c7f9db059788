"""Integration points of the port, the counterparts of __graft_entry__.py:

entry()             -> (fn, example_args): the single-card forward step of
                       the flagship path (Ed25519 batch verify, message form)
                       on the CUDA card (device="cpu": the plain versions).
dryrun_multichip(n) -> the step over a dp x mp mesh of n ranks and the
                       verify pool (parallel/dryrun.py): NCCL ranks on n
                       cards, or with device="cpu" gloo ranks on the CPU.

    python -c "from firedancer_tpu_torch import entry; entry.dryrun_multichip(8, device='cpu')"
"""

from __future__ import annotations

import numpy as np


def entry(device=None):
    from .ops.ed25519 import verify as fver
    from .utils import devices

    dev = devices.resolve(device)
    batch, msg_len = 128, 64
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 256, size=(batch, msg_len), dtype=np.uint8)
    lens = np.full((batch,), msg_len, dtype=np.int32)
    sigs = rng.integers(0, 256, size=(batch, 64), dtype=np.uint8)
    pubs = rng.integers(0, 256, size=(batch, 32), dtype=np.uint8)

    def fn(m, l, s, p):
        return fver.verify_batch(m, l, s, p, device=dev)

    return fn, (msgs, lens, sigs, pubs)


def dryrun_multichip(n_devices: int, device=None) -> None:
    from .parallel import dryrun

    dryrun.run(n_devices, device=device)


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape), str(out.dtype), out.device)
