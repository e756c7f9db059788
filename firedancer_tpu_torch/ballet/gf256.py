"""GF(2^8) arithmetic and matrices for Reed-Solomon shred coding.

A copy of firedancer_tpu/ballet/gf256.py (numpy only, no JAX), kept in the
port so that firedancer_tpu_torch imports nothing of the JAX package.

Field: GF(2^8) mod 0x11D, generator 2 — the field used by Solana's
reed-solomon-erasure backend and the reference's reedsol
(src/ballet/reedsol/; its FFT/PPT machinery is an O(n log n)
factorization of the same code).

The code matrix follows the reed-solomon-erasure construction: an
extended Vandermonde matrix V[r][c] = (α^r)^c made systematic by
right-multiplying with the inverse of its top k×k block, so data shreds
pass through unchanged and parity rows are the bottom n-k rows.

Everything here is small host-side setup (matrices are at most
134×67); the per-byte bulk work is one matrix product on the device in
ops/reedsol.py.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D

EXP = np.zeros(512, dtype=np.uint8)
LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    EXP[_i] = _x
    LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= POLY
EXP[255:510] = EXP[:255]


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def div(a: int, b: int) -> int:
    assert b != 0
    if a == 0:
        return 0
    return int(EXP[(LOG[a] - LOG[b]) % 255])


def inv(a: int) -> int:
    assert a != 0
    return int(EXP[(255 - LOG[a]) % 255])


def mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product (small host matrices)."""
    n, k = A.shape
    k2, m = B.shape
    assert k == k2
    out = np.zeros((n, m), dtype=np.uint8)
    for i in range(n):
        for j in range(m):
            acc = 0
            for t in range(k):
                acc ^= mul(int(A[i, t]), int(B[t, j]))
            out[i, j] = acc
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    """GF(2^8) Gauss-Jordan inversion; raises on singular."""
    n = len(A)
    a = A.astype(np.int32).copy()
    e = np.eye(n, dtype=np.int32)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            e[[col, piv]] = e[[piv, col]]
        iv = inv(int(a[col, col]))
        for j in range(n):
            a[col, j] = mul(int(a[col, j]), iv)
            e[col, j] = mul(int(e[col, j]), iv)
        for r in range(n):
            if r != col and a[r, col]:
                f = int(a[r, col])
                for j in range(n):
                    a[r, j] ^= mul(f, int(a[col, j]))
                    e[r, j] ^= mul(f, int(e[col, j]))
    return e.astype(np.uint8)


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r][c] = (α^r)^c = α^(r·c) (reed-solomon-erasure layout)."""
    out = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            out[r, c] = EXP[(r * c) % 255]
    return out


def code_matrix(data_cnt: int, total_cnt: int) -> np.ndarray:
    """Systematic (total × data) code matrix: top block = identity,
    bottom rows produce parity."""
    assert 0 < data_cnt <= total_cnt <= 255
    v = vandermonde(total_cnt, data_cnt)
    top_inv = mat_inv(v[:data_cnt])
    m = mat_mul(v, top_inv)
    assert (m[:data_cnt] == np.eye(data_cnt, dtype=np.uint8)).all()
    return m


def parity_matrix(data_cnt: int, parity_cnt: int) -> np.ndarray:
    """(parity × data) GF(2^8) matrix mapping data bytes to parity."""
    return code_matrix(data_cnt, data_cnt + parity_cnt)[data_cnt:]


def mul_bitmatrix(c: int) -> np.ndarray:
    """(8, 8) GF(2) matrix of y = c·x over the bits of x:
    column j = bits of c·2^j.  The bit-expansion that turns GF(2^8)
    matrix application into a pure GF(2) matmul (ops/reedsol.py)."""
    out = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = mul(c, 1 << j)
        for i in range(8):
            out[i, j] = (prod >> i) & 1
    return out


def expand_bits(M: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix (P, D) -> GF(2) bit matrix (8P, 8D)."""
    P, D = M.shape
    out = np.zeros((8 * P, 8 * D), dtype=np.uint8)
    for p in range(P):
        for d in range(D):
            out[8 * p : 8 * p + 8, 8 * d : 8 * d + 8] = mul_bitmatrix(
                int(M[p, d])
            )
    return out
