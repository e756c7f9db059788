"""Device-side microblock candidate selection, in plain PyTorch.

The counterpart of firedancer_tpu/ops/pack_select.py (a `lax.scan`, not a
Pallas kernel there): walk candidates in priority order; take one iff its
writable accounts do not intersect any in-use account, its readable accounts
do not intersect any write-in-use account, it fits the remaining CU budget
and the txn limit.  The sequential state is two bitset vectors and two
counters, carried through a Python loop over the K candidates as device
tensors (no host round trip per candidate).

u64 account bitsets arrive from the host engine and are split into 32-bit
halves (held as int32 bit patterns) as the JAX module does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import devices
from ..utils.hotpath import hot_path

#: largest cu_limit the device scan supports; PAD_COST sentinel rows (used
#: by the host engine to pad candidates to a fixed shape) exceed it by
#: construction, so they are never taken
CU_LIMIT_MAX = 2**30 - 1
PAD_COST = 1 << 30


@hot_path(static=("cu_limit", "txn_limit"))
def select_impl(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit: int,
                txn_limit: int):
    """The greedy scan over tensors on one device.

    cand_rw/cand_w: (K, W2) int32 bitset words; in_use_*: (W2,) int32;
    costs: (K,) int64.  Returns (K,) bool take mask on the same device."""
    K = cand_rw.shape[0]
    sel_rw = in_use_rw.clone()
    sel_w = in_use_w.clone()
    zero = torch.zeros((), dtype=torch.int64, device=costs.device)
    cu_used, taken = zero.clone(), zero.clone()
    takes = []
    for i in range(K):
        rw, w, c = cand_rw[i], cand_w[i], costs[i]
        conflict = torch.any((w & sel_rw) != 0) | torch.any((rw & sel_w) != 0)
        take = ~conflict & (cu_used + c <= cu_limit) & (taken < txn_limit)
        sel_rw = torch.where(take, sel_rw | rw, sel_rw)
        sel_w = torch.where(take, sel_w | w, sel_w)
        cu_used = cu_used + torch.where(take, c, zero)
        taken = taken + take.to(torch.int64)
        takes.append(take)
    return torch.stack(takes)


def split_u32(a64: np.ndarray) -> np.ndarray:
    """(..., W) u64 -> (..., 2W) int32 little-endian 32-bit halves."""
    a = np.ascontiguousarray(a64, dtype=np.uint64)
    return a.view(np.int32).reshape(a.shape[:-1] + (-1,))


def check_cu_limit(cu_limit: int) -> None:
    if int(cu_limit) > CU_LIMIT_MAX:
        raise ValueError(
            f"cu_limit {cu_limit} exceeds CU_LIMIT_MAX {CU_LIMIT_MAX}; a "
            "silent clamp would diverge from the host greedy loop"
        )


def select_noconflict(cand_rw, cand_w, in_use_rw, in_use_w, costs,
                      cu_limit: int, txn_limit: int, device=None) -> np.ndarray:
    """Greedy non-conflicting selection over priority-ordered candidates.

    cand_rw/cand_w: (K, W) u64 account bitsets; in_use_*: (W,) u64;
    costs: (K,) int.  Returns the (K,) bool take mask as numpy.  Runs on
    `device` (default: the CUDA card)."""
    check_cu_limit(cu_limit)
    dev = devices.resolve(device)
    t = [
        torch.from_numpy(split_u32(a)).to(dev)
        for a in (cand_rw, cand_w, in_use_rw, in_use_w)
    ]
    costs_t = devices.as_tensor(np.asarray(costs, np.int64), torch.int64, dev)
    takes = select_impl(*t, costs_t, int(cu_limit), int(txn_limit))
    return takes.cpu().numpy()
