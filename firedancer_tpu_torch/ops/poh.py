"""Proof-of-History hash chain ops: the counterpart of
firedancer_tpu/ops/poh.py.

PoH iterates SHA-256 over a 32-byte state; a mixin records an event as
state = SHA-256(state || mixin).  A single chain is sequential by design,
so the batch axis holds many independent chains: `verify_entries` checks
every entry of a slot at once, one lane per entry (the replay side, which
verifies far more PoH than a leader generates).

Every op runs on ops/sha256.py::poh_chain: on the card the fdt_poh_chain
kernel (each lane loops its own hash count in registers), on the CPU the
plain version (every lane runs the batch's largest count, masked, one
batched compression per step).  Each entry point takes `device=None`,
meaning the CUDA card.
"""

from __future__ import annotations

import torch

from ..utils import devices
from . import sha256 as S


def _states(state32, dev):
    st = devices.as_tensor(state32, torch.uint8, dev)
    if st.shape[-1] != 32:
        raise ValueError(f"want (..., 32) uint8 states, got {tuple(st.shape)}")
    return S.words_from_bytes(st.reshape(-1, 32)), st.shape


def append_n(state32, n: int, device=None):
    """Iterate state = SHA-256(state) n times.  state32: (..., 32) uint8 ->
    (..., 32) uint8 on `device`."""
    dev = devices.resolve(device)
    w, shape = _states(state32, dev)
    lanes = w.shape[0]
    out = S.poh_chain(w, torch.full((lanes,), int(n), dtype=torch.int32, device=dev),
                      torch.zeros_like(w), torch.zeros(lanes, dtype=torch.bool, device=dev))
    return S.bytes_from_words(out).reshape(shape)


def mixin(state32, mix32, device=None):
    """state = SHA-256(state || mix): record an event into the chain.
    (..., 32) uint8 each -> (..., 32) uint8 on `device`."""
    dev = devices.resolve(device)
    w, shape = _states(state32, dev)
    m, _ = _states(mix32, dev)
    lanes = w.shape[0]
    out = S.poh_chain(w, torch.zeros(lanes, dtype=torch.int32, device=dev), m,
                      torch.ones(lanes, dtype=torch.bool, device=dev))
    return S.bytes_from_words(out).reshape(shape)


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
    hc = devices.as_tensor(hashcnts, torch.int32, dev)
    if hc.numel() and int(hc.max()) > max_hashcnt:
        raise ValueError(f"hashcnt {int(hc.max())} exceeds max_hashcnt {max_hashcnt}")
    w, _ = _states(start_states, dev)
    m, _ = _states(mixins, dev)
    has = devices.as_tensor(has_mixin, torch.bool, dev)
    out = S.poh_chain(w, torch.where(has, hc - 1, hc), m, has)
    return S.bytes_from_words(out)
