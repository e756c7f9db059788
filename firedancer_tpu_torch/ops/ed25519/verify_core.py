"""The fused Ed25519 verify core: wrapper, plain version and launch counter.

Counterpart of firedancer_tpu/ops/ed25519/pallas_kernel.py::verify_core.  On
a CUDA tensor `verify_core` launches the hand-written Hopper kernel
csrc/verify_core.cu (built by utils/kbuild.py); on a CPU tensor it runs
`verify_core_plain`, the same function in plain PyTorch over point.py and
field.py.  There is no other branch: a CUDA tensor goes through the kernel
or the call raises.

`LAUNCHES` counts kernel launches (never plain runs), so a caller can show
that a run went through the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import kbuild
from . import field as F
from . import golden
from . import point as PT

#: kernel launches since import (reset by setting it to 0)
LAUNCHES = 0

# (squarings, multiplications) per lane of the verify function, counted
# from its formulas in point.py and field.py:
#: one decompression: pow_p58 (251, 11) and (4, 9) around it
_DECOMPRESS = (251 + 4, 11 + 9)
#: the -A table: 4 doublings with T (4, 4 each), 3 additions (0, 9 each)
#: and 8 niels conversions (0, 1 each)
_TABLE = (4 * 4, 4 * 4 + 3 * 9 + 8)
#: 64 steps of 4 doublings (4 squarings each; 3 multiplications, 4 on the
#: last, which makes T), add_niels (8) and add_niels_affine without T (6)
_LOOP = (64 * 4 * 4, 64 * (3 * 3 + 4 + 8 + 6))
#: eq_external's two cross products
_EQ = (0, 2)
#: limbs of an element in the kernel's radix 2^25.5
LIMBS = 10
#: 32x32->64 limb products: a multiplication takes every pair of limbs, a
#: squaring every unordered pair once
PRODUCTS_PER_MUL = LIMBS * LIMBS
PRODUCTS_PER_SQR = LIMBS * (LIMBS + 1) // 2


def field_ops_per_lane() -> tuple:
    """(squarings, multiplications) one lane of the verify function needs."""
    parts = (_DECOMPRESS, _DECOMPRESS, _TABLE, _LOOP, _EQ)
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def products_per_lane() -> int:
    """32x32->64 limb products one lane needs (the kernel's bound counts
    these; it runs squarings as multiplications for now, so it does more)."""
    sqr, mul = field_ops_per_lane()
    return sqr * PRODUCTS_PER_SQR + mul * PRODUCTS_PER_MUL


# radix-2^25.5 limb positions of the kernel's representation
_POS = [0, 26, 51, 77, 102, 128, 153, 179, 204, 230, 255]


def _limbs25(x: int) -> list:
    return [(x >> _POS[i]) & ((1 << (_POS[i + 1] - _POS[i])) - 1)
            for i in range(10)]


def kernel_consts() -> np.ndarray:
    """(300,) int32 constant block of csrc/verify_core.cu: D, 2D, sqrt(-1),
    then the affine niels base table (y+x, y-x, 2dxy) of i*B, i in 0..8,
    all in radix 2^25.5 limbs."""
    vals = [golden.D, 2 * golden.D % golden.P, golden.SQRT_M1]
    for row in PT.base_table9_ints():
        vals.extend(row)
    out = np.array([l for v in vals for l in _limbs25(v)], dtype=np.int32)
    assert out.shape == (300,)
    return out


_CONSTS_ON: dict = {}


def _consts_on(device: torch.device) -> torch.Tensor:
    t = _CONSTS_ON.get(device)
    if t is None:
        t = torch.from_numpy(kernel_consts()).to(device)
        _CONSTS_ON[device] = t
    return t


def verify_core_plain(k_digits, s_digits, a_y, a_sign, r_y, r_sign):
    """Plain PyTorch version: decompress A and R, [k](-A) + [s]B == R."""
    a_pt, a_ok = PT.decompress_limbs(a_y, a_sign)
    r_pt, r_ok = PT.decompress_limbs(r_y, r_sign)
    acc = PT.double_scalar_mul(k_digits, PT.build_neg_table9(a_pt), s_digits)
    return a_ok & r_ok & PT.eq_external(acc, r_pt)


def _check(name, t, rows, B, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != (rows, B):
        raise ValueError(f"{name} must have shape {(rows, B)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(k_digits, s_digits, a_y, a_sign, r_y, r_sign):
    global LAUNCHES
    B = k_digits.shape[-1]
    dev = k_digits.device
    for name, t, rows in (
        ("k_digits", k_digits, 64), ("s_digits", s_digits, 64),
        ("a_y", a_y, F.NLIMB), ("a_sign", a_sign, 1),
        ("r_y", r_y, F.NLIMB), ("r_sign", r_sign, 1),
    ):
        _check(name, t, rows, B, dev)
    lib = kbuild.load("verify_core")
    fn = lib.fdt_verify_core_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _consts_on(dev).data_ptr(), k_digits.data_ptr(),
            s_digits.data_ptr(), a_y.data_ptr(), a_sign.data_ptr(),
            r_y.data_ptr(), r_sign.data_ptr(), out.data_ptr(), B, stream,
        )
    if err != 0:
        raise RuntimeError(f"verify_core kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def verify_core(k_digits, s_digits, a_y, a_sign, r_y, r_sign):
    """Fused decompress + ([k](-A) + [s]B == R) -> (B,) bool.

    k_digits, s_digits: (64, B) int32 signed radix-16 digits in [-8, 7]
    (scalar.to_signed_digits); a_y, r_y: (20, B) int32 13-bit y limbs;
    a_sign, r_sign: (1, B) int32 sign bits (point.decompress_bytes).
    Small-order rejection is the caller's prologue.  CUDA tensors launch
    the kernel; CPU tensors run verify_core_plain."""
    if k_digits.device.type == "cpu":
        return verify_core_plain(k_digits, s_digits, a_y, a_sign, r_y, r_sign)
    if k_digits.device.type != "cuda":
        raise ValueError(f"verify_core: unsupported device {k_digits.device}")
    return _launch(k_digits, s_digits, a_y, a_sign, r_y, r_sign)
