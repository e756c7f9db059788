"""Device-side microblock candidate selection: wrapper, plain version,
the pack tile's selector and launch counter.

The counterpart of firedancer_tpu/ops/pack_select.py (a `lax.scan`, not a
Pallas kernel there): walk candidates in priority order; take one iff its
writable accounts do not intersect any in-use account, its readable accounts
do not intersect any write-in-use account, it fits the remaining CU budget
and the txn limit.

On a CUDA tensor `select_impl` launches the hand-written Hopper kernel
csrc/pack_select.cu (built by utils/kbuild.py) on the current stream: one
block finds every row that can still pass in parallel, then walks a chain
of takes over those rows only.  On a CPU tensor it runs `select_plain`, the
same scan as a Python loop over tensors.  There is no other branch: a CUDA
tensor goes through the kernel or the call raises.  `Selector` is the host
entry the pack tile holds (`select_noconflict(..., selector=)`): numpy in,
one copy each way on a stream of its own.  `LAUNCHES` counts kernel
launches (never plain runs).

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


def _launch(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit, txn_limit,
            stats):
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
    ) + ((("stats", stats, (4,), torch.int64),) if stats is not None else ()):
        _check(name, t, shape, dtype, dev)
    if not 1 <= W2 <= MAX_W2:
        raise ValueError(f"pack_select: W2 = {W2} words, the kernel takes 1..{MAX_W2}")
    out = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return out
    fn = kbuild.load("pack_select").fdt_pack_select_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [
        ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cand_rw.data_ptr(), cand_w.data_ptr(), in_use_rw.data_ptr(),
                 in_use_w.data_ptr(), costs.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), K, W2,
                 cu_limit, txn_limit, stream)
    if err != 0:
        raise RuntimeError(f"pack_select kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


@hot_path(static=("cu_limit", "txn_limit"))
def select_impl(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit: int,
                txn_limit: int, stats=None):
    """The greedy scan over tensors on one device, on the current stream.

    cand_rw/cand_w: (K, W2) int32 bitset words; in_use_*: (W2,) int32;
    costs: (K,) int64.  Returns (K,) bool take mask on the same device.
    CUDA tensors launch the kernel; `stats`, a (4,) int64 CUDA tensor,
    receives its chain's step count and the clock64 cycles of its staging
    and phase 1, its chain and the whole kernel.  CPU tensors run select_plain, which
    counts nothing (`stats` must be None there)."""
    if cand_rw.device.type == "cpu":
        if stats is not None:
            raise ValueError("pack_select: the plain version counts no steps")
        return select_plain(cand_rw, cand_w, in_use_rw, in_use_w, costs,
                            cu_limit, txn_limit)
    if cand_rw.device.type != "cuda":
        raise ValueError(f"pack_select: unsupported device {cand_rw.device}")
    return _launch(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit,
                   txn_limit, stats)


def chain_probe(n: int, device, take_steps: bool) -> torch.Tensor:
    """Launch csrc/pack_select.cu's probe: the chain's warps run n steps on
    rows in shared memory, each a take when `take_steps`, else none; ->
    their clock64 cycles, a (1,) int64 tensor on `device` (not
    synchronized)."""
    fn = kbuild.load("pack_select").fdt_pack_select_chain_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device(device)
    words = torch.zeros(65, dtype=torch.int32, device=dev)
    words[:64] = torch.arange(1, 65, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(words.data_ptr(), n, int(take_steps), cycles.data_ptr(),
                 sink.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pack_select chain probe launch failed: cudaError {err}")
    return cycles


def chain_probe_cycles(n: int, device, take_steps: bool) -> float:
    """Clock cycles of one chain step of the kernel (the probe over n
    steps): a take step, or one that takes nothing."""
    return int(chain_probe(n, device, take_steps).cpu()[0]) / n


def split_u32(a64: np.ndarray) -> np.ndarray:
    """(..., W) u64 -> (..., 2W) int32 little-endian 32-bit halves."""
    a = np.ascontiguousarray(a64, dtype=np.uint64)
    return a.view(np.int32).reshape(a.shape[:-1] + (2 * a.shape[-1],))


def check_cu_limit(cu_limit: int) -> None:
    if int(cu_limit) > CU_LIMIT_MAX:
        raise ValueError(
            f"cu_limit {cu_limit} exceeds CU_LIMIT_MAX {CU_LIMIT_MAX}; a "
            "silent clamp would diverge from the host greedy loop"
        )


def seg_rows(W2: int) -> int:
    """Rows of one segment of the kernel (csrc/pack_select.cu
    fdt_pack_select_seg_rows, which the CPU tests hold this to): what its
    shared memory stages up to 64 words a row, else 4096.  Each segment
    after the first may add one chain step to ceil(live / 32) + takes."""
    return 512 if W2 <= 32 else 256 if W2 <= 64 else 4096


class Selector:
    """One pack tile's select: the kernel behind one copy each way.

    Owns, once `ready()` has run, a host staging block laid out as the
    kernel's five inputs end to end (`views`; the offsets are this class's
    alone), and on a CUDA device: the block pinned, a device block of the
    same layout, a pinned and a device output block (the kernel's stats,
    then the take mask), and a high-priority stream of its own, which does
    not wait for the legacy default stream where the verify worker
    launches.  A call on the card is one C call (fdt_pack_select_call),
    run without the GIL: it copies the numpy rows into the pinned block at
    the views' offsets (u64 words are the little-endian pairs of 32-bit
    words the kernel reads; no temporaries), copies the block in, launches
    the kernel on the device block at the same offsets, copies the stats
    and takes out and waits for the stream.  One release of the GIL a
    select: numpy's and torch's copies would each release and retake it,
    and under the tile threads' contention every retake waits.  On the CPU
    (`device="cpu"`) numpy writes the same views and select_plain reads
    them.  Rows are at most `k_max` and `w` u64 words wide.  Not
    thread-safe: one tile's thread owns it."""

    def __init__(self, k_max: int, w: int, device=None):
        self.device = devices.resolve(device)
        self.k_max, self.w = int(k_max), int(w)
        if not 1 <= 2 * self.w <= MAX_W2:
            raise ValueError(f"pack_select: {self.w} u64 words a row, the kernel "
                             f"takes 1..{MAX_W2 // 2}")
        #: the kernel's stats of the last call on the card: chain steps, then
        #: the clock64 cycles of staging and phase 1, of the chain, of the
        #: kernel
        self.stats = None
        self._host = None

    def ready(self) -> None:
        """Build and load the kernel, allocate the blocks and make the
        stream (on the CPU: the staging block); idempotent."""
        if self._host is not None:
            return
        nbytes = self._offsets(self.k_max)[-1]
        if self.device.type == "cpu":
            self._host = np.zeros(nbytes, np.uint8)
            return
        fn = kbuild.load("pack_select").fdt_pack_select_call
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
            ctypes.c_int64] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(self.device):
            self._stream = torch.cuda.Stream(self.device, priority=-1)
            self._bufs = (
                torch.zeros(nbytes, dtype=torch.uint8, pin_memory=True),
                torch.empty(nbytes, dtype=torch.uint8, device=self.device),
                torch.zeros(32 + self.k_max, dtype=torch.uint8, pin_memory=True),
                torch.empty(32 + self.k_max, dtype=torch.uint8, device=self.device),
            )
        self._ptrs = [b.data_ptr() for b in self._bufs]
        self._src = (ctypes.c_void_p * 5)()
        self._off = (ctypes.c_size_t * 6)()
        self._out = self._bufs[2].numpy()
        self._fn = fn
        self._host = self._bufs[0].numpy()

    def _offsets(self, K: int) -> list:
        """Byte offsets in the input block of cand_rw (K, w) u64, cand_w,
        in_use_rw (w,) u64, in_use_w, costs (K,) int64, and its end."""
        rb, wb = K * self.w * 8, self.w * 8
        return [0, rb, 2 * rb, 2 * rb + wb, 2 * rb + 2 * wb, 2 * rb + 2 * wb + 8 * K]

    def views(self, K: int):
        """The staging block's views for K rows: cand_rw, cand_w (K, w)
        u64, in_use_rw, in_use_w (w,) u64, costs (K,) int64."""
        o, b = self._offsets(K), self._host
        return (b[o[0]:o[1]].view(np.uint64).reshape(K, self.w),
                b[o[1]:o[2]].view(np.uint64).reshape(K, self.w),
                b[o[2]:o[3]].view(np.uint64), b[o[3]:o[4]].view(np.uint64),
                b[o[4]:o[5]].view(np.int64))

    def __call__(self, cand_rw, cand_w, in_use_rw, in_use_w, costs,
                 cu_limit: int, txn_limit: int) -> np.ndarray:
        """The (K,) bool take mask of the greedy, as numpy (a fresh array)."""
        global LAUNCHES
        src = [np.ascontiguousarray(a, np.uint64)
               for a in (cand_rw, cand_w, in_use_rw, in_use_w)]
        src.append(np.ascontiguousarray(costs, np.int64))
        K, w = len(src[4]), self.w
        for name, a, shape in zip(("cand_rw", "cand_w", "in_use_rw", "in_use_w"), src,
                                  ((K, w), (K, w), (w,), (w,))):
            if a.shape != shape:
                raise ValueError(f"{name} must have shape {shape}, got {a.shape}")
        if K > self.k_max:
            raise ValueError(f"pack_select: {K} candidates, the selector holds "
                             f"{self.k_max}")
        self.ready()
        if self.device.type == "cpu":
            dst = self.views(K)
            for d, a in zip(dst, src):
                np.copyto(d, a)
            words = [torch.from_numpy(d.view(np.int32).reshape(d.shape[:-1] + (2 * w,)))
                     for d in dst[:4]]
            return select_plain(*words, torch.from_numpy(dst[4]), cu_limit,
                                txn_limit).numpy()
        if K == 0:
            return np.zeros(0, bool)
        self._src[:] = [a.ctypes.data for a in src]
        self._off[:] = self._offsets(K)
        with torch.cuda.device(self.device):
            err = self._fn(self._src, self._off, *self._ptrs, K, 2 * w, cu_limit,
                           txn_limit, self._stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"pack_select select call failed: cudaError {err}")
        LAUNCHES += 1
        self.stats = self._out[:32].view(np.int64).tolist()
        return self._out[32:32 + K].astype(bool)


def select_noconflict(cand_rw, cand_w, in_use_rw, in_use_w, costs,
                      cu_limit: int, txn_limit: int, device=None,
                      selector: Selector | None = None) -> np.ndarray:
    """Greedy non-conflicting selection over priority-ordered candidates.

    cand_rw/cand_w: (K, W) u64 account bitsets; in_use_*: (W,) u64;
    costs: (K,) int.  Returns the (K,) bool take mask as numpy.  Runs
    through `selector` (a pack tile's, sized once), else through a
    Selector made for this call on `device` (default: the CUDA card)."""
    check_cu_limit(cu_limit)
    if selector is None:
        selector = Selector(len(costs), np.shape(in_use_rw)[0], device)
    return selector(cand_rw, cand_w, in_use_rw, in_use_w, costs, int(cu_limit),
                    int(txn_limit))
