"""Batched SHA-256: plain PyTorch over int64 words, and the two kernels of
csrc/sha256.cu.

The counterpart of firedancer_tpu/ops/sha256.py.  A SHA-256 word is a
32-bit big-endian value; torch's uint32 has no `+`, `>>` or `<` on the CPU,
so the plain versions carry each word in an int64 lane (value in
[0, 2^32)) and mask with `& 0xFFFFFFFF`, as ops/sha512.py does for its
64-bit words.  Every word tensor of this module is int64 in that form; the
kernels take and give bytes.

Entry points (each takes `device=None`, meaning the CUDA card):
  sha256(msgs, lens)   -> (B, 32) uint8 digests of variable-length messages
  sha256_words32(w8)   -> SHA-256 of 32-byte messages given as 8 words
  sha256_words64(w16)  -> SHA-256 of 64-byte messages given as 16 words
  words_from_bytes, bytes_from_words: the big-endian conversions

The two functions the kernels compute, each with its plain version:
  sha256_bytes(msgs, lens)                       (kernel fdt_sha256_blocks:
      padding, words and every block of a lane in one launch; plain:
      padded_words, then sha256_blocks_plain over the words)
  poh_chain_bytes(state, n_plain, mixin, has_mixin)  (kernel fdt_poh_chain
      on 32-byte states; plain: poh_chain_plain over the words.  The PoH
      ops of ops/poh.py run on it; poh_chain, its words form, converts in
      the wrapper and carries the fixed-size forms above)
A CUDA tensor goes through the kernel or the call raises; a CPU tensor runs
the plain version.  `LAUNCHES` counts kernel launches by kernel name (never
plain runs).
"""

from __future__ import annotations

import ctypes
import functools

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


def sha256_bytes_plain(msgs, lens):
    """(B, W) uint8 messages, (B,) lengths -> (B, 32) uint8 digests: the
    JAX package's _sha256_impl over int64 words (padded_words, then
    sha256_blocks_plain)."""
    return bytes_from_words(sha256_blocks_plain(*padded_words(msgs, lens)))


def poh_chain_bytes_plain(state, n_plain, mixin, has_mixin):
    """poh_chain_plain on (B, 32) uint8 states and mixins -> (B, 32) uint8."""
    return bytes_from_words(poh_chain_plain(
        words_from_bytes(state), n_plain, words_from_bytes(mixin), has_mixin))


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # msgs, lens, lens64, out, B, width, stream
    "fdt_sha256_blocks_launch": [_PTR, _PTR, _INT, _PTR, _INT, ctypes.c_int64, _PTR],
    # state, n_plain, mixin, has_mixin, out, B, stream
    "fdt_poh_chain_launch": [_PTR] * 5 + [_INT, _PTR],
}


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str):
    """csrc/sha256.cu's C function `name`, bound once per process (the
    library is built and loaded on first use)."""
    fn = getattr(kbuild.load("sha256"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(name, t, shape, dtype):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: want a {dtype} CUDA tensor of shape {shape}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _aligned(t):
    """A contiguous tensor whose data starts on 16 bytes (the kernels load
    32-byte rows as two 16-byte words)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launched(kernel, err):
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1


def sha256_args(msgs, lens):
    """Checked kernel inputs of sha256_bytes on the card and a fresh output:
    -> (msgs, lens, out).  lens stays int32 or int64 (the kernel reads
    either); another integer type is converted to int64."""
    if lens.dtype not in (torch.int32, torch.int64):
        lens = lens.to(torch.int64)
    msgs, lens = msgs.contiguous(), lens.contiguous()
    bsz, width = msgs.shape
    _check("msgs", msgs, (bsz, width), torch.uint8)
    _check("lens", lens, (bsz,), lens.dtype)
    if lens.device != msgs.device:
        raise ValueError(f"lens on {lens.device}, msgs on {msgs.device}")
    return msgs, lens, torch.empty((bsz, 32), dtype=torch.uint8, device=msgs.device)


def sha256_call(msgs, lens, out, stream) -> int:
    """One launch of fdt_sha256_blocks on sha256_args' tensors; -> the CUDA
    error code.  Counts nothing (sha256_bytes counts its launches)."""
    bsz, width = msgs.shape
    return kernel_fn("fdt_sha256_blocks_launch")(
        msgs.data_ptr(), lens.data_ptr(), int(lens.dtype == torch.int64),
        out.data_ptr(), bsz, width, stream)


def _launch_sha256(msgs, lens):
    msgs, lens, out = sha256_args(msgs, lens)
    with torch.cuda.device(msgs.device):
        err = sha256_call(msgs, lens, out, torch.cuda.current_stream().cuda_stream)
    _launched("sha256_blocks", err)
    return out


def poh_args(state, n_plain, mixin, has_mixin):
    """Checked kernel inputs of poh_chain_bytes on the card and a fresh
    output: -> (state, n_plain, mixin, has_mixin, out)."""
    bsz = state.shape[0]
    st, mx = _aligned(state), _aligned(mixin)
    n = n_plain.to(torch.int32).contiguous()
    hm = has_mixin.contiguous()
    hm = hm.view(torch.uint8) if hm.dtype == torch.bool else hm.to(torch.uint8)
    _check("state", st, (bsz, 32), torch.uint8)
    _check("mixin", mx, (bsz, 32), torch.uint8)
    _check("n_plain", n, (bsz,), torch.int32)
    _check("has_mixin", hm, (bsz,), torch.uint8)
    return st, n, mx, hm, torch.empty((bsz, 32), dtype=torch.uint8, device=st.device)


def poh_call(state, n_plain, mixin, has_mixin, out, stream) -> int:
    """One launch of fdt_poh_chain on poh_args' tensors; -> the CUDA error
    code.  Counts nothing (poh_chain_bytes counts its launches)."""
    return kernel_fn("fdt_poh_chain_launch")(
        state.data_ptr(), n_plain.data_ptr(), mixin.data_ptr(), has_mixin.data_ptr(),
        out.data_ptr(), state.shape[0], stream)


def _launch_poh_chain(state, n_plain, mixin, has_mixin):
    args = poh_args(state, n_plain, mixin, has_mixin)
    with torch.cuda.device(state.device):
        err = poh_call(*args, torch.cuda.current_stream().cuda_stream)
    _launched("poh_chain", err)
    return args[-1]


def _dispatch(name, plain, launch, t, *args):
    if t.device.type == "cpu":
        return plain(t, *args)
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return launch(t, *args)


def sha256_bytes(msgs, lens):
    """(B, W) uint8 messages, (B,) lengths (0 <= lens[i] <= W) -> (B, 32)
    uint8 digests.  CUDA tensors launch fdt_sha256_blocks once; CPU
    tensors run sha256_bytes_plain."""
    return _dispatch("sha256_bytes", sha256_bytes_plain, _launch_sha256, msgs, lens)


def poh_chain_bytes(state, n_plain, mixin, has_mixin):
    """max(n_plain[i], 0) appends state = SHA-256(state), then, where
    has_mixin[i], state = SHA-256(state || mixin[i]).  state, mixin: (B, 32)
    uint8; n_plain: (B,) integers; has_mixin: (B,) bool -> (B, 32) uint8.
    CUDA tensors launch fdt_poh_chain; CPU tensors run
    poh_chain_bytes_plain."""
    return _dispatch("poh_chain_bytes", poh_chain_bytes_plain, _launch_poh_chain,
                     state, n_plain, mixin, has_mixin)


def poh_chain(state, n_plain, mixin, has_mixin):
    """poh_chain_plain's words form: on CUDA tensors the wrapper converts
    the words to bytes and back around fdt_poh_chain; CPU tensors run
    poh_chain_plain."""
    if state.device.type == "cpu":
        return poh_chain_plain(state, n_plain, mixin, has_mixin)
    out = poh_chain_bytes(bytes_from_words(state), n_plain, bytes_from_words(mixin),
                          has_mixin)
    return words_from_bytes(out)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _lens(lens, dev):
    """(B,) lengths on `dev`, int32 or int64 as given (the kernel reads
    either), any other type as int64."""
    t = lens if isinstance(lens, torch.Tensor) else torch.as_tensor(lens)
    dtype = t.dtype if t.dtype in (torch.int32, torch.int64) else torch.int64
    return t.to(device=dev, dtype=dtype).contiguous()


def sha256(msgs, lens, device=None):
    """Batch SHA-256.  msgs: (B, max_len) uint8; lens: (B,) byte counts
    (numpy arrays or tensors) -> (B, 32) uint8 digests on `device`.  On
    the card one launch of fdt_sha256_blocks, and no other device work
    for uint8 messages and int32 or int64 lengths.

    Contract as firedancer_tpu/ops/sha256.py: 0 <= lens[j] <= max_len <
    2^28 for every lane."""
    dev = devices.resolve(device)
    msgs = devices.as_tensor(msgs, torch.uint8, dev)
    if msgs.shape[1] >= MAX_LEN:
        raise ValueError(f"max_len {msgs.shape[1]} >= 2^28 unsupported")
    return sha256_bytes(msgs, _lens(lens, dev))


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
                    w, torch.zeros(n, dtype=torch.bool, device=w.device))
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
