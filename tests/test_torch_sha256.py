"""The port's batched SHA-256 against hashlib and the JAX package, and the
plain-C++ host build of csrc/sha256.cu (both kernels) against hashlib, under
the signed-overflow and shift sanitizer.  Digests and words are compared
exactly."""

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
    src = (kbuild.CSRC / "sha256.cu").read_text()
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


@pytest.fixture(scope="module")
def host_sha(tmp_path_factory):
    lib = host_library(tmp_path_factory, "sha256")
    lib.fdt_sha256_blocks_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.fdt_sha256_blocks_host.restype = None
    lib.fdt_poh_chain_host.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    lib.fdt_poh_chain_host.restype = None
    return lib


def host_blocks(lib, words, nblocks):
    """fdt_sha256_blocks' host form on (B, max_blocks, 16) int64 words."""
    w = np.ascontiguousarray(words.numpy().astype(np.uint32))
    nb = np.ascontiguousarray(nblocks.numpy().astype(np.int32))
    out = np.zeros((w.shape[0], 8), np.uint32)
    lib.fdt_sha256_blocks_host(w.ctypes.data, nb.ctypes.data, out.ctypes.data,
                               w.shape[0], w.shape[1])
    return out.astype(np.int64)


def host_chain(lib, state, n_plain, mixin, has_mixin):
    """fdt_poh_chain's host form on numpy words and counts."""
    arrs = [np.ascontiguousarray(a, t) for a, t in
            ((state, np.uint32), (n_plain, np.int32), (mixin, np.uint32),
             (has_mixin, np.uint8))]
    out = np.zeros((len(n_plain), 8), np.uint32)
    lib.fdt_poh_chain_host(*(a.ctypes.data for a in arrs), out.ctypes.data, len(n_plain))
    return out.astype(np.int64)


def test_blocks_kernel_matches_hashlib(host_sha, capfd):
    msgs, lens = _batch(9, LENGTHS + [1000, 17], 1232)
    words, nblocks = ST.padded_words(torch.from_numpy(msgs), torch.from_numpy(lens))
    got = ST.bytes_from_words(torch.from_numpy(host_blocks(host_sha, words, nblocks))).numpy()
    assert [got[i].tobytes() for i in range(len(lens))] == _hashlib(msgs, lens)
    assert_no_sanitizer_report(capfd)


def test_blocks_kernel_matches_plain_on_random_counts(host_sha, capfd):
    """Random words, block counts from none to past max_blocks: the kernel
    compresses min(n, max_blocks) blocks, as the plain version's mask does."""
    rng = np.random.default_rng(13)
    words = torch.from_numpy(rng.integers(0, 1 << 32, (7, 4, 16), np.int64))
    nblocks = torch.tensor([0, 1, 2, 3, 4, 6, -1], dtype=torch.int32)
    np.testing.assert_array_equal(host_blocks(host_sha, words, nblocks),
                                  ST.sha256_blocks_plain(words, nblocks).numpy())
    assert_no_sanitizer_report(capfd)


def test_chain_kernel_matches_hashlib(host_sha, capfd):
    rng = np.random.default_rng(17)
    n = np.array([-1, 0, 1, 2, 5, 0, 1, 9], np.int32)
    has = np.array([1, 1, 1, 0, 1, 0, 0, 0], bool)
    st = rng.integers(0, 256, (len(n), 32), np.uint8)
    mx = rng.integers(0, 256, (len(n), 32), np.uint8)
    words = lambda b: ST.words_from_bytes(torch.from_numpy(b)).numpy()  # noqa: E731
    got = host_chain(host_sha, words(st), n, words(mx), has)
    for i in range(len(n)):
        s = st[i].tobytes()
        for _ in range(max(int(n[i]), 0)):
            s = hashlib.sha256(s).digest()
        if has[i]:
            s = hashlib.sha256(s + mx[i].tobytes()).digest()
        assert ST.bytes_from_words(torch.from_numpy(got[i])).numpy().tobytes() == s, i
    np.testing.assert_array_equal(
        got, ST.poh_chain_plain(*(torch.from_numpy(a) for a in (words(st), n, words(mx), has))).numpy())
    assert_no_sanitizer_report(capfd)
