"""Batched SHA-256: plain PyTorch over int64 words, and the two kernels of
csrc/sha256.cu.

The counterpart of firedancer_tpu/ops/sha256.py.  A SHA-256 word is a
32-bit big-endian value; torch's uint32 has no `+`, `>>` or `<` on the CPU,
so the plain versions carry each word in an int64 lane (value in
[0, 2^32)) and mask with `& 0xFFFFFFFF`, as ops/sha512.py does for its
64-bit words.  Every word tensor of this module is int64 in that form.

Entry points (each takes `device=None`, meaning the CUDA card):
  sha256(msgs, lens)   -> (B, 32) uint8 digests of variable-length messages
  sha256_words32(w8)   -> SHA-256 of 32-byte messages given as 8 words
  sha256_words64(w16)  -> SHA-256 of 64-byte messages given as 16 words
  words_from_bytes, bytes_from_words: the big-endian conversions

The two functions the kernels compute, each with its plain version:
  sha256_blocks(words, nblocks)             (kernel fdt_sha256_blocks)
  poh_chain(state, n_plain, mixin, has_mixin)  (kernel fdt_poh_chain; the
      PoH ops of ops/poh.py and the fixed-size forms above run on it)
A CUDA tensor goes through the kernel or the call raises; a CPU tensor runs
the plain version.  `LAUNCHES` counts kernel launches by kernel name (never
plain runs).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import devices, kbuild
from ..utils.shaconst import H32 as _H32
from ..utils.shaconst import K32 as _K32

M32 = 0xFFFFFFFF
MAX_LEN = 1 << 28  # max_len bound of the contract: bit lengths stay < 2^31

#: kernel launches since import, by kernel (reset by setting each to 0)
LAUNCHES = {"sha256_blocks": 0, "poh_chain": 0}

_H = torch.tensor(_H32, dtype=torch.int64)


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def compress(state, w):
    """One SHA-256 compression (plain).  state: (B, 8); w: (B, 16) words."""
    a, b, c, d, e, f, g, h = state.unbind(1)
    ws = list(w.unbind(1))
    for t in range(64):
        if t >= 16:
            w15, w2 = ws[t - 15], ws[t - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> 3)
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> 10)
            ws.append((ws[t - 16] + s0 + ws[t - 7] + s1) & M32)
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + _K32[t] + ws[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + s0 + maj) & M32
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & M32


def _init(batch: int, device):
    return _H.to(device).expand(batch, 8)


def words_from_bytes(b):
    """(..., 4k) uint8 -> (..., k) big-endian words."""
    by = b.reshape(b.shape[:-1] + (b.shape[-1] // 4, 4)).to(torch.int64)
    return (by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8) | by[..., 3]


def bytes_from_words(w):
    """(..., k) words -> (..., 4k) uint8, big-endian."""
    shifts = torch.tensor([24, 16, 8, 0], device=w.device)
    out = (w[..., None] >> shifts) & 0xFF
    return out.reshape(w.shape[:-1] + (4 * w.shape[-1],)).to(torch.uint8)


def padded_words(msgs, lens):
    """(B, max_len) uint8, (B,) lengths -> (B, max_blocks, 16) words of each
    lane's padded message and (B,) int32 block counts: 0x80 after the
    message, zeros, the 64-bit big-endian bit length closing the lane's
    last block (firedancer_tpu/ops/sha256.py::_pad)."""
    bsz, width = msgs.shape
    max_blocks = (width + 9 + 63) // 64
    total = max_blocks * 64
    dev = msgs.device
    buf = torch.zeros((bsz, total), dtype=torch.uint8, device=dev)
    buf[:, :width] = msgs
    pos = torch.arange(total, device=dev)[None, :]
    lens_c = lens.to(torch.int64)[:, None]
    buf = torch.where(pos < lens_c, buf, torch.zeros_like(buf))
    buf = torch.where(pos == lens_c, torch.full_like(buf, 0x80), buf)
    nblocks = (lens_c + 9 + 63) // 64
    pfe = pos - (nblocks * 64 - 8)
    in_len = (pfe >= 0) & (pfe < 8)
    shift = (8 * (7 - pfe)).clamp(0, 63)
    len_byte = ((lens_c * 8) >> shift) & 0xFF
    buf = torch.where(in_len, len_byte.to(torch.uint8), buf)
    return words_from_bytes(buf).reshape(bsz, max_blocks, 16), nblocks[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# the two kernels' functions: plain versions and launches
# ---------------------------------------------------------------------------


def sha256_blocks_plain(words, nblocks):
    """Each lane's first nblocks[i] blocks of `words` (B, max_blocks, 16)
    compressed from the initial state -> (B, 8) words.  Every lane runs
    max_blocks masked compressions, as the JAX block scan does."""
    bsz, max_blocks, _ = words.shape
    state = _init(bsz, words.device)
    for blk in range(max_blocks):
        nxt = compress(state, words[:, blk])
        state = torch.where((blk < nblocks)[:, None], nxt, state)
    return state


def _mixin_words(state, mixin):
    """SHA-256(state || mixin) of (B, 8) words each: two compressions."""
    bsz = state.shape[0]
    st = compress(_init(bsz, state.device), torch.cat([state, mixin], dim=1))
    pad = torch.zeros((bsz, 16), dtype=torch.int64, device=state.device)
    pad[:, 0] = 0x80000000
    pad[:, 15] = 64 * 8
    return compress(st, pad)


def _append_words(state):
    """SHA-256(state) of (B, 8) words: one compression, padding constant."""
    bsz = state.shape[0]
    pad = torch.zeros((bsz, 8), dtype=torch.int64, device=state.device)
    pad[:, 0] = 0x80000000
    pad[:, 7] = 32 * 8
    return compress(_init(bsz, state.device), torch.cat([state, pad], dim=1))


def poh_chain_plain(state, n_plain, mixin, has_mixin):
    """max(n_plain[i], 0) appends state = SHA-256(state), then, where
    has_mixin[i], state = SHA-256(state || mixin[i]).  state, mixin: (B, 8)
    words; n_plain: (B,) integers; has_mixin: (B,) bool -> (B, 8) words.
    Every lane runs max(n_plain) masked appends
    (firedancer_tpu/ops/poh.py::_verify_entries_impl)."""
    steps = int(n_plain.max()) if n_plain.numel() else 0
    for i in range(steps):
        state = torch.where((i < n_plain)[:, None], _append_words(state), state)
    return torch.where(has_mixin[:, None], _mixin_words(state, mixin), state)


def _lib_fn(fn_name, argtypes):
    fn = getattr(kbuild.load("sha256"), fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want a {dtype} CUDA tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _u32(w):
    """int64 words -> contiguous int32 with the same low 32 bits."""
    return w.to(torch.int32).contiguous()


def _launched(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def _launch_sha256_blocks(words, nblocks):
    bsz, max_blocks, _ = words.shape
    dev = words.device
    w32, nb = _u32(words), nblocks.to(torch.int32).contiguous()
    _check("words", w32, (bsz, max_blocks, 16), torch.int32)
    _check("nblocks", nb, (bsz,), torch.int32)
    out = torch.empty((bsz, 8), dtype=torch.int32, device=dev)
    fn = _lib_fn("fdt_sha256_blocks_launch",
                 [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(w32.data_ptr(), nb.data_ptr(), out.data_ptr(), bsz, max_blocks, stream)
    _launched("sha256_blocks", err)
    return out.to(torch.int64) & M32


def _launch_poh_chain(state, n_plain, mixin, has_mixin):
    bsz = state.shape[0]
    dev = state.device
    st, mx = _u32(state), _u32(mixin)
    n = n_plain.to(torch.int32).contiguous()
    hm = has_mixin.to(torch.uint8).contiguous()
    _check("state", st, (bsz, 8), torch.int32)
    _check("mixin", mx, (bsz, 8), torch.int32)
    _check("n_plain", n, (bsz,), torch.int32)
    _check("has_mixin", hm, (bsz,), torch.uint8)
    out = torch.empty((bsz, 8), dtype=torch.int32, device=dev)
    fn = _lib_fn("fdt_poh_chain_launch",
                 [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(st.data_ptr(), n.data_ptr(), mx.data_ptr(), hm.data_ptr(),
                 out.data_ptr(), bsz, stream)
    _launched("poh_chain", err)
    return out.to(torch.int64) & M32


def _dispatch(name, plain, launch, t, *args):
    if t.device.type == "cpu":
        return plain(t, *args)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return launch(t, *args)


def sha256_blocks(words, nblocks):
    """(B, max_blocks, 16) padded words, (B,) block counts -> (B, 8) state
    words.  CUDA tensors launch fdt_sha256_blocks; CPU tensors run
    sha256_blocks_plain."""
    return _dispatch("sha256_blocks", sha256_blocks_plain, _launch_sha256_blocks,
                     words, nblocks)


def poh_chain(state, n_plain, mixin, has_mixin):
    """See poh_chain_plain.  CUDA tensors launch fdt_poh_chain; CPU tensors
    run poh_chain_plain."""
    return _dispatch("poh_chain", poh_chain_plain, _launch_poh_chain,
                     state, n_plain, mixin, has_mixin)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def sha256(msgs, lens, device=None):
    """Batch SHA-256.  msgs: (B, max_len) uint8; lens: (B,) byte counts
    (numpy arrays or tensors) -> (B, 32) uint8 digests on `device`.

    Contract as firedancer_tpu/ops/sha256.py: 0 <= lens[j] <= max_len <
    2^28 for every lane."""
    dev = devices.resolve(device)
    msgs = devices.as_tensor(msgs, torch.uint8, dev)
    lens = devices.as_tensor(lens, torch.int64, dev)
    if msgs.shape[1] >= MAX_LEN:
        raise ValueError(f"max_len {msgs.shape[1]} >= 2^28 unsupported")
    return bytes_from_words(sha256_blocks(*padded_words(msgs, lens)))


def _fixed(w, width, device):
    dev = devices.resolve(device)
    w = devices.as_tensor(w, torch.int64, dev)
    if w.shape[-1] != width:
        raise ValueError(f"want (..., {width}) words, got {tuple(w.shape)}")
    return w.reshape(-1, width), w.shape[:-1]


def sha256_words32(w8, device=None):
    """SHA-256 of 32-byte messages as (..., 8) big-endian words -> (..., 8)
    digest words: one compression, the PoH append.  Runs poh_chain with one
    append per lane."""
    w, lead = _fixed(w8, 8, device)
    n = w.shape[0]
    out = poh_chain(w, torch.ones(n, dtype=torch.int32, device=w.device),
                    torch.zeros_like(w), torch.zeros(n, dtype=torch.bool, device=w.device))
    return out.reshape(lead + (8,))


def sha256_words64(w16, device=None):
    """SHA-256 of 64-byte messages as (..., 16) words -> (..., 8) digest
    words: two compressions, the PoH mixin.  Runs poh_chain with no append
    and the message's second half as the mixin."""
    w, lead = _fixed(w16, 16, device)
    n = w.shape[0]
    out = poh_chain(w[:, :8], torch.zeros(n, dtype=torch.int32, device=w.device),
                    w[:, 8:], torch.ones(n, dtype=torch.bool, device=w.device))
    return out.reshape(lead + (8,))
