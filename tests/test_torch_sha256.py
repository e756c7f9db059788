"""The port's batched SHA-256 against hashlib and the JAX package, and the
plain-C++ host build of csrc/sha256.cu (both kernels, bytes in and out)
against hashlib, JAX and the plain versions, under the signed-overflow and
shift sanitizer.  Digests and words are compared exactly."""

import ctypes
import hashlib
import re

import numpy as np
import pytest
import torch

from firedancer_tpu.ops import sha256 as SJ
from firedancer_tpu_torch.ops import sha256 as ST
from firedancer_tpu_torch.utils import kbuild
from firedancer_tpu_torch.utils import shaconst
from test_torch_verify_core import assert_no_sanitizer_report, host_library

LENGTHS = [0, 1, 55, 56, 63, 64, 119, 120, 1232]


def _batch(seed, lengths, width):
    rng = np.random.default_rng(seed)
    lens = np.array(lengths, np.int64)
    msgs = rng.integers(0, 256, (len(lens), width), np.uint8)
    msgs[np.arange(width)[None, :] >= lens[:, None]] = 0
    return msgs, lens


def _hashlib(msgs, lens):
    return [hashlib.sha256(msgs[i, :n].tobytes()).digest() for i, n in enumerate(lens)]


def test_constants_match_jax_and_kernel_table():
    assert shaconst.K32 == [int(k) for k in SJ._K32]
    assert shaconst.H32 == [int(h) for h in SJ._H32]
    src = (kbuild.CSRC / "sha256.cuh").read_text()
    k_table = src.split("K256[64] = {", 1)[1].split("}", 1)[0]
    h_table = src.split("H256[8] = {", 1)[1].split("}", 1)[0]
    assert [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", k_table)] == shaconst.K32
    assert [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", h_table)] == shaconst.H32


def test_sha256_matches_hashlib_and_jax():
    msgs, lens = _batch(5, LENGTHS, 1232)
    got = ST.sha256(msgs, lens, device="cpu").numpy()
    assert [got[i].tobytes() for i in range(len(lens))] == _hashlib(msgs, lens)
    np.testing.assert_array_equal(got, np.asarray(SJ.sha256(msgs, lens.astype(np.int32))))


@pytest.mark.parametrize("width", [1, 64, 200])
def test_sha256_widths(width):
    rng = np.random.default_rng(width)
    lens = rng.integers(0, width + 1, 6)
    msgs, lens = _batch(width + 1, lens, width)
    got = ST.sha256(torch.from_numpy(msgs), torch.from_numpy(lens), device="cpu").numpy()
    assert [got[i].tobytes() for i in range(len(lens))] == _hashlib(msgs, lens)


def test_sha256_rejects_max_len_2_28():
    with pytest.raises(ValueError, match="2\\^28"):
        ST.sha256(torch.zeros((0, 1 << 28), dtype=torch.uint8), torch.zeros(0), device="cpu")


def test_words_roundtrip_matches_jax():
    rng = np.random.default_rng(3)
    b = rng.integers(0, 256, (5, 64), np.uint8)
    w = ST.words_from_bytes(torch.from_numpy(b))
    np.testing.assert_array_equal(w.numpy(), np.asarray(SJ.words_from_bytes(b)).astype(np.int64))
    np.testing.assert_array_equal(ST.bytes_from_words(w).numpy(), b)


@pytest.mark.parametrize("nbytes", [32, 64])
def test_fixed_forms_match_jax_and_hashlib(nbytes):
    rng = np.random.default_rng(nbytes)
    b = rng.integers(0, 256, (2, 3, nbytes), np.uint8)
    words = np.asarray(SJ.words_from_bytes(b))
    port = ST.sha256_words32 if nbytes == 32 else ST.sha256_words64
    jaxf = SJ.sha256_words32 if nbytes == 32 else SJ.sha256_words64
    got = port(words.astype(np.int64), device="cpu")
    assert got.shape == (2, 3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jaxf(words)).astype(np.int64))
    digests = ST.bytes_from_words(got).numpy().reshape(6, 32)
    flat = b.reshape(6, nbytes)
    assert [d.tobytes() for d in digests] == [hashlib.sha256(m.tobytes()).digest() for m in flat]


# ---------------------------------------------------------------------------
# the kernels' host build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens_dtype", [np.int32, np.int64])
def test_sha256_bytes_plain_matches_hashlib(lens_dtype):
    """The kernel's plain version on (B, W) bytes and int32 or int64
    lengths, as the entry point hands them on."""
    msgs, lens = _batch(6, LENGTHS, 1232)
    got = ST.sha256_bytes(torch.from_numpy(msgs), torch.from_numpy(lens.astype(lens_dtype)))
    assert [got[i].numpy().tobytes() for i in range(len(lens))] == _hashlib(msgs, lens)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.int16, torch.uint8])
def test_entry_lens_keep_int32_and_int64(dtype):
    """sha256 hands int32 and int64 lengths on as they are (the kernel
    reads either) and widens any other integer type to int64."""
    got = ST._lens(torch.tensor([3, 0, 7], dtype=dtype), torch.device("cpu"))
    assert got.dtype == (dtype if dtype in (torch.int32, torch.int64) else torch.int64)
    assert got.tolist() == [3, 0, 7]


def test_blocks_plain_matches_jax_compress_on_random_counts():
    """The words-form plain path (sha256_blocks_plain) on random words and
    block counts from none to past max_blocks, against the JAX package's
    _compress_block scanned the same way."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    words = rng.integers(0, 1 << 32, (7, 4, 16), np.int64)
    nblocks = np.array([0, 1, 2, 3, 4, 6, -1], np.int32)
    state = jnp.broadcast_to(jnp.asarray(SJ._H32), (7, 8))
    for blk in range(4):
        nxt = SJ._compress_block(state, jnp.asarray(words[:, blk].astype(np.uint32)))
        state = jnp.where((blk < nblocks)[:, None], nxt, state)
    got = ST.sha256_blocks_plain(torch.from_numpy(words), torch.from_numpy(nblocks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(state).astype(np.int64))


# ---------------------------------------------------------------------------
# the kernels' host build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_sha(tmp_path_factory):
    lib = host_library(tmp_path_factory, "sha256")
    lib.fdt_sha256_blocks_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int64]
    lib.fdt_sha256_blocks_host.restype = None
    lib.fdt_poh_chain_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    lib.fdt_poh_chain_host.restype = None
    return lib


#: where the first row starts in its 16-byte granule: the kernel stages
#: every row from the granule that holds it, so each offset (with odd widths,
#: every row's) takes another byte shift
OFFSETS = (0, 1, 6, 15)


def at_offset(msgs, offset):
    """A copy of `msgs` whose first byte lies `offset` bytes past a 16-byte
    boundary."""
    buf = np.zeros(msgs.size + 32, np.uint8)
    start = (-buf.ctypes.data) % 16 + offset
    out = buf[start:start + msgs.size].reshape(msgs.shape)
    out[...] = msgs
    assert out.ctypes.data % 16 == offset
    return out


def host_digests(lib, msgs, lens, offset=0):
    """fdt_sha256_blocks' host form on (B, W) uint8 messages (placed
    `offset` bytes past a 16-byte boundary) and (B,) int32 or int64
    lengths -> (B, 32) uint8 digests."""
    m = at_offset(np.ascontiguousarray(msgs, np.uint8), offset)
    ln = np.ascontiguousarray(lens)
    assert ln.dtype in (np.int32, np.int64)
    out = np.zeros((m.shape[0], 32), np.uint8)
    lib.fdt_sha256_blocks_host(m.ctypes.data, ln.ctypes.data, int(ln.dtype == np.int64),
                               out.ctypes.data, m.shape[0], m.shape[1])
    return out


def host_chain(lib, state, n_plain, mixin, has_mixin):
    """fdt_poh_chain's host form on (B, 32) uint8 states and mixins ->
    (B, 32) uint8."""
    arrs = [np.ascontiguousarray(a, t) for a, t in
            ((state, np.uint8), (n_plain, np.int32), (mixin, np.uint8),
             (has_mixin, np.uint8))]
    out = np.zeros((len(n_plain), 32), np.uint8)
    lib.fdt_poh_chain_host(*(a.ctypes.data for a in arrs), out.ctypes.data, len(n_plain))
    return out


@pytest.mark.parametrize("width", [1232, 1231, 200, 120, 66, 64, 63, 1])
def test_blocks_kernel_matches_hashlib(host_sha, capfd, width):
    """The edge lengths that fit the width, and the width itself, with the
    rows at every offset of OFFSETS: hashlib and the JAX sha256."""
    lengths = [n for n in LENGTHS + [1000, 17, 65] if n <= width] + [width]
    msgs, lens = _batch(9 + width, lengths, width)
    want = np.asarray(SJ.sha256(msgs, lens.astype(np.int32)))
    for off in OFFSETS:
        got = host_digests(host_sha, msgs, lens, off)
        assert [got[i].tobytes() for i in range(len(lens))] == _hashlib(msgs, lens), off
        np.testing.assert_array_equal(got, want)
    assert_no_sanitizer_report(capfd)


@pytest.mark.parametrize("seed,width,lanes", [(21, 1232, 70), (22, 200, 33), (23, 68, 5),
                                              (24, 65, 40), (25, 1231, 35)])
def test_blocks_kernel_matches_plain_on_random_counts(host_sha, capfd, seed, width, lanes):
    """Random ragged batches over more than one warp: the host build at
    every offset against hashlib and the plain version; lengths past
    the width (a contract breach) read zeros past the row, as the plain
    version's padded_words does."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, width + 1, lanes)
    msgs, lens = _batch(seed, lens, width)
    for dtype in (np.int32, np.int64):
        got = host_digests(host_sha, msgs, lens.astype(dtype))
        assert [got[i].tobytes() for i in range(lanes)] == _hashlib(msgs, lens)
    over = lens.copy()
    over[::3] += rng.integers(1, 130, len(over[::3]))
    plain = ST.sha256_bytes_plain(torch.from_numpy(msgs), torch.from_numpy(over)).numpy()
    for off in OFFSETS:
        np.testing.assert_array_equal(host_digests(host_sha, msgs, over, off), plain)
    assert_no_sanitizer_report(capfd)


def test_chain_kernel_matches_hashlib(host_sha, capfd):
    rng = np.random.default_rng(17)
    n = np.array([-1, 0, 1, 2, 5, 0, 1, 9], np.int32)
    has = np.array([1, 1, 1, 0, 1, 0, 0, 0], bool)
    st = rng.integers(0, 256, (len(n), 32), np.uint8)
    mx = rng.integers(0, 256, (len(n), 32), np.uint8)
    got = host_chain(host_sha, st, n, mx, has)
    for i in range(len(n)):
        s = st[i].tobytes()
        for _ in range(max(int(n[i]), 0)):
            s = hashlib.sha256(s).digest()
        if has[i]:
            s = hashlib.sha256(s + mx[i].tobytes()).digest()
        assert got[i].tobytes() == s, i
    args = [torch.from_numpy(a) for a in (st, n, mx, has)]
    np.testing.assert_array_equal(got, ST.poh_chain_bytes_plain(*args).numpy())
    np.testing.assert_array_equal(got, ST.poh_chain_bytes(*args).numpy())
    assert_no_sanitizer_report(capfd)


def test_bound_counts_the_compressions_operations():
    """chip_smoke's issue bound counts FIPS 180-4's operations, not a
    kernel's: 64 rounds of six rotates, four three-input logic operations
    and four adds, 48 schedule steps of six shifts, two xors and two
    three-input adds' worth of terms, eight adds of the state; constant
    words fold (a constant W leaves h + W + K one two-input add) and so does
    a constant state; the ALU pipe's rotates and logic bind
    once the adds move to the FMA pipe."""
    from chip_smoke import pipe_split, sha_compression_ops, sha_ops

    full = sha_compression_ops()
    assert full == {"alu": 64 * 10 + 48 * 8, "add2": 64 + 48 + 8, "add3": 3 * 64 + 48}
    assert pipe_split(full) == (1024, 600)
    const = sha_compression_ops(range(16))
    assert const == {"alu": 64 * 10, "add2": 2 * 64 + 8, "add3": 2 * 64}
    poh = sha_compression_ops(range(8, 16), const_state=True)
    assert poh["alu"] < sha_compression_ops(const_state=True)["alu"] < full["alu"]
    assert sha_ops((3, full), (2, {"alu": 8})) == {
        "alu": 3 * full["alu"] + 16, "add2": 3 * full["add2"], "add3": 3 * full["add3"]}
