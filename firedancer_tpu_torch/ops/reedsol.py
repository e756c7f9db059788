"""Reed-Solomon shred coding as one GF(2) matrix product: the counterpart
of firedancer_tpu/ops/reedsol.py.

GF(2^8) matrix application is GF(2)-linear in the bits.  Expanding each
field constant to its 8x8 GF(2) multiply matrix (ballet/gf256.expand_bits)
turns "parity = M · data over GF(2^8)" into one binary matrix product over
all N byte positions at once,

    parity_bits (8P, N) = B (8P, 8D) @ data_bits (8D, N)   (mod 2),

which is `torch.matmul` here, as it is an XLA dot in the JAX package (no
Pallas kernel).  Recovery inverts the surviving rows' GF(2^8) matrix on the
host (at most 67 x 67) and reuses the same product.

The product runs in float32 (MATMUL_DTYPE).  Its operands are 0 and 1 and a
column sum is at most 8·D ≤ 536 (DATA_SHREDS_MAX = 67), so every sum is an
exact float32 integer, also where the card multiplies in TF32 (0 and 1 are
exact in TF32's 10-bit mantissa and the products accumulate in float32).
bfloat16 holds integers exactly only up to 256 and would flip parity bits
silently; float16 (exact to 2048) would do on the card but is slow or
missing on CPUs.  There is no public int8 matrix product on CUDA in torch.

JAX's `encode` switches to the host path below a size (HOST_MAX_BYTES, the
shredder's dispatch policy, from an environment variable).  The port does
not carry that switch: `encode` runs on the device it is given
(`device=None` is the CUDA card), and `_encode_host` stays as the numpy
oracle.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ballet import gf256 as GF
from ..utils import devices

DATA_SHREDS_MAX = 67  # FD_REEDSOL_DATA_SHREDS_MAX
#: operand type of the GF(2) product: exact for column sums up to 2^24
MATMUL_DTYPE = torch.float32


@functools.lru_cache(maxsize=64)
def _parity_bits_matrix(data_cnt: int, parity_cnt: int) -> np.ndarray:
    return GF.expand_bits(GF.parity_matrix(data_cnt, parity_cnt))


def _unpack_bits(x):
    """(D, N) uint8 -> (8D, N) uint8 bits (bit i of row d at row 8d+i)."""
    d, n = x.shape
    return torch.stack([(x >> i) & 1 for i in range(8)], dim=1).reshape(8 * d, n)


def _pack_bits(bits):
    """(8P, N) integer bits -> (P, N) uint8."""
    p8, n = bits.shape
    b = bits.reshape(p8 // 8, 8, n).to(torch.int32)
    out = torch.zeros((p8 // 8, n), dtype=torch.int32, device=bits.device)
    for i in range(8):
        out |= b[:, i] << i
    return out.to(torch.uint8)


def _apply_bitmatrix(bmat, data):
    """(P, N) uint8 = unpack, product mod 2, pack of data (D, N) uint8 by the
    bit matrix bmat (8P, 8D) of 0/1, both on one device."""
    bits = _unpack_bits(data).to(MATMUL_DTYPE)
    acc = torch.matmul(bmat.to(MATMUL_DTYPE), bits)
    return _pack_bits(acc.to(torch.int32) & 1)


def _encode_host(data: np.ndarray, parity_cnt: int) -> np.ndarray:
    """Host bit-matrix encode: identical math, numpy int ops (the oracle)."""
    d, n = data.shape
    bmat = _parity_bits_matrix(d, parity_cnt).astype(np.int32)  # (8P, 8D)
    xi = data.astype(np.int32)
    bits = np.stack([(xi >> i) & 1 for i in range(8)], axis=1).reshape(8 * d, n)
    acc = (bmat @ bits) & 1  # (8P, N)
    b = acc.reshape(parity_cnt, 8, n)
    out = np.zeros((parity_cnt, n), np.int32)
    for i in range(8):
        out |= b[:, i, :] << i
    return out.astype(np.uint8)


def encode(data, parity_cnt: int, device=None):
    """data (D, N) uint8 (D shreds of N bytes) -> parity (parity_cnt, N)
    uint8 tensor on `device`.  Reference semantics: fd_reedsol_encode
    init/add/fini in one shot."""
    dev = devices.resolve(device)
    data = devices.as_tensor(data, torch.uint8, dev)
    bmat = torch.from_numpy(_parity_bits_matrix(data.shape[0], parity_cnt)).to(dev)
    return _apply_bitmatrix(bmat, data)


def recover(shreds, present, data_cnt: int, device=None):
    """Reconstruct the data shreds from any data_cnt surviving rows.

    shreds (total, N) uint8 with garbage in missing rows; present (total,)
    bool.  -> (data_cnt, N) uint8 tensor on `device`, or None when fewer
    than data_cnt rows survive (FD_REEDSOL_ERR_PARTIAL)."""
    dev = devices.resolve(device)
    keep = torch.as_tensor(present).cpu().numpy()
    idx = np.flatnonzero(keep)
    if len(idx) < data_cnt:
        return None
    idx = idx[:data_cnt]
    total = len(keep)
    sub = GF.code_matrix(data_cnt, total)[idx]  # survivors = sub @ data
    bmat = torch.from_numpy(GF.expand_bits(GF.mat_inv(sub))).to(dev)
    shreds = devices.as_tensor(shreds, torch.uint8, dev)
    surv = shreds[torch.from_numpy(idx).to(dev)]
    return _apply_bitmatrix(bmat, surv)
