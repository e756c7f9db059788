"""Proof-of-History hash chain ops: the counterpart of
firedancer_tpu/ops/poh.py.

PoH iterates SHA-256 over a 32-byte state; a mixin records an event as
state = SHA-256(state || mixin).  A single chain is sequential by design,
so the batch axis holds many independent chains: `verify_entries` checks
every entry of a slot at once, one lane per entry (the replay side, which
verifies far more PoH than a leader generates).

Every op runs on ops/sha256.py::poh_chain_bytes: on the card one launch
of the fdt_poh_chain kernel (each group of 32 lanes loops its largest
hash count, the state in registers, 32-byte states in and out), on the
CPU the plain version (every lane runs the batch's largest count,
masked, one batched compression per step).  The per-lane counts are made where the caller's inputs lie (on the
host for numpy inputs) and copied; no word tensor is made on the card.
Each entry point takes `device=None`, meaning the CUDA card.
"""

from __future__ import annotations

import torch

from ..utils import devices
from . import sha256 as S


def _states(state32, dev):
    st = devices.as_tensor(state32, torch.uint8, dev)
    if st.shape[-1] != 32:
        raise ValueError(f"want (..., 32) uint8 states, got {tuple(st.shape)}")
    return st.reshape(-1, 32), st.shape


def _lanes(value, lanes: int, dtype, dev):
    """(lanes,) of one value on `dev`, made on the host and copied."""
    return torch.full((lanes,), value, dtype=dtype).to(dev)


def append_n(state32, n: int, device=None):
    """Iterate state = SHA-256(state) n times.  state32: (..., 32) uint8 ->
    (..., 32) uint8 on `device`."""
    dev = devices.resolve(device)
    st, shape = _states(state32, dev)
    lanes = st.shape[0]
    out = S.poh_chain_bytes(st, _lanes(int(n), lanes, torch.int32, dev), st,
                            _lanes(False, lanes, torch.bool, dev))
    return out.reshape(shape)


def mixin(state32, mix32, device=None):
    """state = SHA-256(state || mix): record an event into the chain.
    (..., 32) uint8 each -> (..., 32) uint8 on `device`."""
    dev = devices.resolve(device)
    st, shape = _states(state32, dev)
    mx, _ = _states(mix32, dev)
    lanes = st.shape[0]
    out = S.poh_chain_bytes(st, _lanes(0, lanes, torch.int32, dev), mx,
                            _lanes(True, lanes, torch.bool, dev))
    return out.reshape(shape)


def verify_entries(start_states, hashcnts, mixins, has_mixin, max_hashcnt: int,
                   device=None):
    """Batch-verify PoH entries, one lane per entry.

    start_states: (B, 32) uint8, the state before each entry; hashcnts:
    (B,) hashes in the entry; mixins: (B, 32) uint8 (ignored where not
    has_mixin); has_mixin: (B,) bool; max_hashcnt: the bound every
    hashcnt must keep (ValueError otherwise).  -> (B, 32) uint8 end states
    on `device`; the caller checks end[i] == start[i + 1].

    A mixin entry is hashcnt - 1 plain appends and then SHA-256(state ||
    mixin) (the mixin consumes one hash); a tick entry is hashcnt appends.
    hashcnt 0 with a mixin is the mixin alone, without one the start state
    (firedancer_tpu/ops/poh.py::_verify_entries_impl)."""
    dev = devices.resolve(device)
    hc = torch.as_tensor(hashcnts).to(torch.int32)  # where the caller holds it
    if hc.numel() and int(hc.max()) > max_hashcnt:
        raise ValueError(f"hashcnt {int(hc.max())} exceeds max_hashcnt {max_hashcnt}")
    has = torch.as_tensor(has_mixin).to(device=hc.device, dtype=torch.bool)
    n_plain = torch.where(has, hc - 1, hc).to(dev)
    st, _ = _states(start_states, dev)
    mx, _ = _states(mixins, dev)
    return S.poh_chain_bytes(st, n_plain, mx, has.to(dev))
