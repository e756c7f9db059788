"""Device-side microblock candidate selection: wrapper, plain version and
launch counter.

The counterpart of firedancer_tpu/ops/pack_select.py (a `lax.scan`, not a
Pallas kernel there): walk candidates in priority order; take one iff its
writable accounts do not intersect any in-use account, its readable accounts
do not intersect any write-in-use account, it fits the remaining CU budget
and the txn limit.

On a CUDA tensor `select_impl` launches the hand-written Hopper kernel
csrc/pack_select.cu (built by utils/kbuild.py): one block carries the
selected sets in registers through the K candidates.  On a CPU tensor it
runs `select_plain`, the same scan as a Python loop over tensors.  There is
no other branch: a CUDA tensor goes through the kernel or the call raises.
`LAUNCHES` counts kernel launches (never plain runs).

u64 account bitsets arrive from the host engine and are split into 32-bit
halves (held as int32 bit patterns) as the JAX module does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import devices, kbuild
from ..utils.hotpath import hot_path

#: largest cu_limit the device scan supports; PAD_COST sentinel rows (used
#: by the host engine to pad candidates to a fixed shape) exceed it by
#: construction, so they are never taken
CU_LIMIT_MAX = 2**30 - 1
PAD_COST = 1 << 30
#: widest bitset row (32-bit words) the kernel takes: 1024 threads of
#: eight words (csrc/pack_select.cu PS_MAX_W2)
MAX_W2 = 8192

#: kernel launches since import (reset by setting it to 0)
LAUNCHES = 0


def select_plain(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit: int,
                 txn_limit: int):
    """The plain version: the greedy scan as a loop over tensors on one
    device, the sequential state carried as device tensors (no host round
    trip per candidate)."""
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
    if not takes:
        return torch.zeros(0, dtype=torch.bool, device=costs.device)
    return torch.stack(takes)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit, txn_limit):
    global LAUNCHES
    if cand_rw.dim() != 2:
        raise ValueError(f"cand_rw must be (K, W2), got {tuple(cand_rw.shape)}")
    K, W2 = cand_rw.shape
    dev = cand_rw.device
    for name, t, shape, dtype in (
        ("cand_rw", cand_rw, (K, W2), torch.int32),
        ("cand_w", cand_w, (K, W2), torch.int32),
        ("in_use_rw", in_use_rw, (W2,), torch.int32),
        ("in_use_w", in_use_w, (W2,), torch.int32),
        ("costs", costs, (K,), torch.int64),
    ):
        _check(name, t, shape, dtype, dev)
    if not 1 <= W2 <= MAX_W2:
        raise ValueError(f"pack_select: W2 = {W2} words, the kernel takes 1..{MAX_W2}")
    out = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return out
    fn = kbuild.load("pack_select").fdt_pack_select_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cand_rw.data_ptr(), cand_w.data_ptr(), in_use_rw.data_ptr(),
                 in_use_w.data_ptr(), costs.data_ptr(), out.data_ptr(), K, W2,
                 cu_limit, txn_limit, stream)
    if err != 0:
        raise RuntimeError(f"pack_select kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


@hot_path(static=("cu_limit", "txn_limit"))
def select_impl(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit: int,
                txn_limit: int):
    """The greedy scan over tensors on one device.

    cand_rw/cand_w: (K, W2) int32 bitset words; in_use_*: (W2,) int32;
    costs: (K,) int64.  Returns (K,) bool take mask on the same device.
    CUDA tensors launch the kernel; CPU tensors run select_plain."""
    if cand_rw.device.type == "cpu":
        return select_plain(cand_rw, cand_w, in_use_rw, in_use_w, costs,
                            cu_limit, txn_limit)
    if cand_rw.device.type != "cuda":
        raise ValueError(f"pack_select: unsupported device {cand_rw.device}")
    return _launch(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit,
                   txn_limit)


def prepare(device) -> None:
    """Build and load the kernel for a CUDA `device` without launching it,
    so a tile's first select does not pay the build; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        kbuild.load("pack_select")


def chain_probe(n: int, device) -> torch.Tensor:
    """Launch csrc/pack_select.cu's probe: one warp runs n dependent steps
    of the kernel's decision on register words; -> its clock64 cycles, a
    (1,) int64 tensor on `device` (not synchronized)."""
    fn = kbuild.load("pack_select").fdt_pack_select_chain_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device(device)
    words = torch.arange(1, 65, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(words.data_ptr(), n, cycles.data_ptr(), sink.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pack_select chain probe launch failed: cudaError {err}")
    return cycles


def chain_probe_cycles(n: int, device) -> float:
    """Clock cycles of one dependent step of the kernel's decision (the
    probe over n steps)."""
    return int(chain_probe(n, device).cpu()[0]) / n


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
    `device` (default: the CUDA card, through the kernel)."""
    check_cu_limit(cu_limit)
    dev = devices.resolve(device)
    t = [
        torch.from_numpy(split_u32(a)).to(dev)
        for a in (cand_rw, cand_w, in_use_rw, in_use_w)
    ]
    costs_t = devices.as_tensor(np.asarray(costs, np.int64), torch.int64, dev)
    takes = select_impl(*t, costs_t, int(cu_limit), int(txn_limit))
    return takes.cpu().numpy()
