"""Batch (random-linear-combination) verification: the two kernels of the
RLC path, their plain versions and launch counters, and the finalization.

Counterpart of firedancer_tpu/ops/ed25519/msm_kernel.py.  Batch
verification checks ONE group equation for a whole batch,

    [sum_i z_i s_i] B  ==  sum_i [z_i k_i] A_i  +  sum_i [z_i] R_i,

with secret random odd 128-bit z_i.  The right-hand side is a 2B-point
multi-scalar multiplication, computed Pippenger-style:

  * `decompress_niels` decompresses A and R and emits affine niels forms
    (csrc/decompress_niels.cu; plain version `decompress_niels_plain`);
  * `msm_buckets` sorts every signed radix-16 digit's term into buckets
    (csrc/msm.cu; plain version `msm_buckets_plain`);
  * `msm_finalize` reduces the buckets over lane slots, combines each
    window's buckets as descending running sums, runs the Horner spine over
    the 64 windows and compares with [u]B.  This is XLA in the JAX package
    and stays plain PyTorch here.

The bucket layout is the port's own (see csrc/msm.cu): 64 windows times S
lane slots, 8 buckets each, output (64, 8, 4, NLIMB, S).  Slot `s` takes
lanes s, s + S, ... in order and adds, for each, +-A_i by its c = z k mod L
digit and, in the first 33 windows, +-R_i by its z digit; so the kernel and
the plain version make the same additions in the same order and agree
exactly after F.canonical.  The kernel runs each bucket set as a team of
four threads (csrc/team.cuh) and sends zero digits to a trash bucket 0, as
the plain version does.

A wrapper runs the plain version only for CPU tensors; a CUDA tensor goes
through the kernel or the call raises.  `LAUNCHES` counts kernel launches
by kernel name (never plain runs).
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import kbuild
from ...utils.hotpath import hot_path
from . import field as F
from . import point as PT
from . import verify_core as VC

NL = F.NLIMB
NWIN = 64  # 4-bit signed windows covering a 252-bit scalar + carry
ZWIN = 33  # windows covering a 128-bit z + carry
NBUCKET = 8  # one bucket per |digit| in 1..8
SLOTS = 256  # lane slots per window at full width

#: kernel launches since import, by kernel (reset by setting each to 0)
LAUNCHES = {"decompress_niels": 0, "msm_buckets": 0}

#: (squarings, multiplications) per lane of decompress_niels: two
#: decompressions and one multiplication by 2d per point
DECOMPRESS_NIELS_OPS = (2 * VC._DECOMPRESS[0], 2 * VC._DECOMPRESS[1] + 2)
#: multiplications of one bucket addition (add_niels_affine with T)
ADD_MULS = 7
#: multiplications the kernel's team runs per addition: two rounds of one
#: per member (member 2 multiplies Z by the entry's 2Z = 2)
KERNEL_ADD_MULS = 2 * VC.TEAM
#: teams of the kernel in one block of 128 threads
TEAMS_PER_BLOCK = 32


def decompress_niels_products_per_lane() -> int:
    """32x32->64 limb products one lane of decompress_niels needs."""
    sqr, mul = DECOMPRESS_NIELS_OPS
    return sqr * VC.PRODUCTS_PER_SQR + mul * VC.PRODUCTS_PER_MUL


def msm_products(cdig, zdig) -> int:
    """32x32->64 limb products the bucket pass needs on these digits: one
    addition per nonzero digit (a zero digit adds nothing)."""
    nonzero = int(torch.count_nonzero(cdig)) + int(torch.count_nonzero(zdig[:ZWIN]))
    return nonzero * ADD_MULS * VC.PRODUCTS_PER_MUL


def msm_kernel_steps(batch: int, slots: int) -> int:
    """Team additions the kernel runs for a batch of `batch` lanes at S =
    `slots`: each of the 64 S teams (team t: window t // S, slot t % S)
    runs its block's step count, that of the block's first team: 2n for a
    window < ZWIN (A then R per lane), n for the others, n = ceil(B / S).
    Zero digits and lanes past the batch are additions too (into the trash
    bucket)."""
    n = -(-batch // slots)
    teams = NWIN * slots
    return sum(
        min(TEAMS_PER_BLOCK, teams - t0) * (2 * n if t0 // slots < ZWIN else n)
        for t0 in range(0, teams, TEAMS_PER_BLOCK))


def msm_kernel_products(batch: int, slots: int | None = None) -> int:
    """32x32->64 limb products the kernel runs (more than msm_products
    needs: the team's extra multiplication per addition, zero digits and
    the ragged edge)."""
    slots = slots_for(batch) if slots is None else slots
    return (msm_kernel_steps(batch, slots) * KERNEL_ADD_MULS
            * VC.PRODUCTS_PER_MUL)


def slots_for(batch: int) -> int:
    """Lane slots per window: one per lane, a power of two, at most SLOTS."""
    return min(SLOTS, 1 << max(0, (batch - 1).bit_length()))


def _lib_fn(lib_name, fn_name, argtypes):
    fn = getattr(kbuild.load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _checked(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# decompress_niels
# ---------------------------------------------------------------------------


def decompress_niels_plain(a_y, a_sign, r_y, r_sign):
    """Plain PyTorch version: decompress A and R, emit affine niels."""
    a_pt, a_ok = PT.decompress_limbs(a_y, a_sign)
    r_pt, r_ok = PT.decompress_limbs(r_y, r_sign)
    return (
        torch.cat(PT.to_niels_affine(a_pt), dim=0),
        torch.cat(PT.to_niels_affine(r_pt), dim=0),
        a_ok & r_ok,
    )


def _launch_decompress_niels(a_y, a_sign, r_y, r_sign):
    B = a_y.shape[-1]
    dev = a_y.device
    for name, t, rows in (
        ("a_y", a_y, NL), ("a_sign", a_sign, 1),
        ("r_y", r_y, NL), ("r_sign", r_sign, 1),
    ):
        VC._check(name, t, rows, B, dev)
    fn = _lib_fn("decompress_niels", "fdt_decompress_niels_launch",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p])
    an3 = torch.empty((3 * NL, B), dtype=torch.int32, device=dev)
    rn3 = torch.empty((3 * NL, B), dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            VC._consts_on(dev).data_ptr(), a_y.data_ptr(), a_sign.data_ptr(),
            r_y.data_ptr(), r_sign.data_ptr(), an3.data_ptr(), rn3.data_ptr(),
            ok.data_ptr(), B, stream,
        )
    _checked("decompress_niels", err)
    return an3, rn3, ok


@hot_path
def decompress_niels(a_y, a_sign, r_y, r_sign):
    """(y limbs, sign) x2 -> (an3 (3NL, B), rn3 (3NL, B), ok (B,) bool).

    a_y, r_y: (20, B) int32 13-bit y limbs; a_sign, r_sign: (1, B) int32
    (point.decompress_bytes).  an3/rn3 are the affine niels (y+x, y-x,
    2dxy) of A and R; lanes with !ok carry garbage that the caller masks to
    the identity before the MSM.  CUDA tensors launch the kernel (canonical
    limbs out); CPU tensors run decompress_niels_plain (carried limbs)."""
    if a_y.device.type == "cpu":
        return decompress_niels_plain(a_y, a_sign, r_y, r_sign)
    if a_y.device.type != "cuda":
        raise ValueError(f"decompress_niels: unsupported device {a_y.device}")
    return _launch_decompress_niels(a_y, a_sign, r_y, r_sign)


# ---------------------------------------------------------------------------
# msm_buckets
# ---------------------------------------------------------------------------


def _add_into_buckets(state, d, n3):
    """One addition in every bucket set of `state`, coords (NL, R, 9, S):
    set (r, s) adds the affine niels column s of n3 (3NL, S), negated where
    d (R, S) < 0, into its bucket |d[r, s]|."""
    rows, slots = d.shape
    ypx, ymx, t2d = (n3[i * NL : (i + 1) * NL, None].expand(NL, rows, slots)
                     .reshape(NL, -1) for i in range(3))
    neg = (d < 0).reshape(1, -1)
    e = (torch.where(neg, ymx, ypx), torch.where(neg, ypx, ymx),
         torch.where(neg, -t2d, t2d))
    idx = d.abs().long()[None, :, None, :].expand(NL, rows, 1, slots)
    cur = tuple(c.gather(2, idx).reshape(NL, -1) for c in state)
    new = PT.add_niels_affine(cur, e, with_t=True)
    for c, n in zip(state, new):
        c.scatter_(2, idx, n.reshape(NL, rows, 1, slots))


def msm_buckets_plain(cdig, zdig, an3, rn3, slots):
    """Plain PyTorch version of the bucket pass, the kernel's additions in
    the kernel's order: step j adds lane j*S + s into bucket set (w, s) for
    every window and slot at once, A by its c digit, then R by its z digit
    in the first ZWIN windows.  Bucket 0 is a trash bucket that takes the
    zero digits' additions and is dropped from the output."""
    B = cdig.shape[-1]
    dev = cdig.device
    ident = PT.identity(NWIN * (NBUCKET + 1) * slots, dev)
    state = [c.reshape(NL, NWIN, NBUCKET + 1, slots).clone() for c in ident]
    z_state = [c[:, :ZWIN] for c in state]  # views: scatter_ writes through
    for j in range(-(-B // slots)):
        lanes = j * slots + torch.arange(slots, device=dev)
        valid = lanes < B
        lanes = lanes.clamp(max=B - 1)
        _add_into_buckets(state, torch.where(valid, cdig[:, lanes], 0), an3[:, lanes])
        _add_into_buckets(z_state, torch.where(valid, zdig[:ZWIN, lanes], 0),
                          rn3[:, lanes])
    # (4, NL, NWIN, 8, S) -> (NWIN, 8, 4, NL, S)
    return torch.stack([c[:, :, 1:] for c in state]).permute(2, 3, 0, 1, 4).contiguous()


def _launch_msm_buckets(cdig, zdig, an3, rn3, slots):
    B = cdig.shape[-1]
    dev = cdig.device
    for name, t, rows in (
        ("cdig", cdig, NWIN), ("zdig", zdig, ZWIN),
        ("an3", an3, 3 * NL), ("rn3", rn3, 3 * NL),
    ):
        VC._check(name, t, rows, B, dev)
    fn = _lib_fn("msm", "fdt_msm_buckets_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                          ctypes.c_void_p])
    out = torch.empty((NWIN, NBUCKET, 4, NL, slots), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(cdig.data_ptr(), zdig.data_ptr(), an3.data_ptr(),
                 rn3.data_ptr(), out.data_ptr(), B, slots, stream)
    _checked("msm_buckets", err)
    return out


def msm_buckets(cdig, zdig, an3, rn3, slots=None):
    """Bucket pass of sum [c_i]A_i + sum [z_i]R_i -> (64, 8, 4, NL, S).

    cdig (64, B) and zdig (33, B) int32 signed digits in [-8, 8]; an3, rn3
    (3NL, B) int32 affine niels of A_i and R_i (identity niels and zero
    digits for lanes left out of the batch); `slots` S, a power of two
    (default slots_for(B)).  CUDA tensors launch the kernel; CPU tensors
    run msm_buckets_plain."""
    slots = slots_for(cdig.shape[-1]) if slots is None else slots
    if slots < 1 or slots & (slots - 1):
        raise ValueError(f"slots must be a power of two, got {slots}")
    if cdig.device.type == "cpu":
        return msm_buckets_plain(cdig, zdig, an3, rn3, slots)
    if cdig.device.type != "cuda":
        raise ValueError(f"msm_buckets: unsupported device {cdig.device}")
    return _launch_msm_buckets(cdig, zdig, an3, rn3, slots)


# ---------------------------------------------------------------------------
# finalization (plain PyTorch: O(windows * buckets) point ops)
# ---------------------------------------------------------------------------


def _tree_reduce_lanes(coords):
    """Point coords (NL, *shape, LANES) -> (NL, *shape) by pairwise adds;
    LANES is a power of two.  Each level flattens to one batch axis for the
    add and restores the shape after."""
    shape = coords[0].shape[1:-1]
    while coords[0].shape[-1] > 1:
        half = coords[0].shape[-1] // 2
        a = tuple(c[..., :half].reshape(NL, -1) for c in coords)
        b = tuple(c[..., half:].reshape(NL, -1) for c in coords)
        coords = tuple(c.reshape((NL,) + shape + (half,)) for c in PT.add(a, b))
    return tuple(c[..., 0] for c in coords)


def window_sums(buckets):
    """Buckets (64, 8, 4, NL, S) -> window sums W_w, coords (NL, 64).

    Sum the bucket sets over slots, then sum_v v * bucket_v as descending
    running sums."""
    coords = tuple(buckets[:, :, c].permute(2, 0, 1, 3) for c in range(4))
    bk = _tree_reduce_lanes(coords)  # (NL, NWIN, 8): bucket v at index v - 1
    s = tuple(c[:, :, NBUCKET - 1] for c in bk)
    t = s
    for v in range(NBUCKET - 2, -1, -1):
        s = PT.add(s, tuple(c[:, :, v] for c in bk))
        t = PT.add(t, s)
    return t


def msm_sum(buckets):
    """Buckets -> the MSM's value, a point with batch 1: Horner over the
    windows, high to low, acc = 16 acc + W_w."""
    w = window_sums(buckets)
    acc = PT.identity(1, buckets.device)
    for idx in range(NWIN - 1, -1, -1):
        acc = PT.double(acc, with_t=False)
        acc = PT.double(acc, with_t=False)
        acc = PT.double(acc, with_t=False)
        acc = PT.double(acc, with_t=True)
        acc = PT.add(acc, tuple(c[:, idx : idx + 1] for c in w))
    return acc


def msm_finalize(buckets, u_digits):
    """Does the bucketed MSM equal [u]B?  u_digits (64, 1) -> () bool."""
    return PT.eq_points(msm_sum(buckets), PT.scalar_mul_base(u_digits))[0]


@hot_path(static=("slots",))
def msm_check(cdig, zdig, an3, rn3, u_digits, slots=None):
    """Does  sum [c_i]A_i + sum [z_i]R_i  ==  [u]B ?  -> () bool tensor.

    The bucket pass (kernel on the card) and the plain finalization."""
    return msm_finalize(msm_buckets(cdig, zdig, an3, rn3, slots), u_digits)
