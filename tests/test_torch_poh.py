"""The port's PoH ops against hashlib and the JAX package, and the host
build of csrc/sha256.cu's fdt_poh_chain against the JAX verify_entries.
States are compared byte for byte."""

import hashlib

import jax
import numpy as np
import pytest
import torch

from firedancer_tpu.ops import poh as PJ
from firedancer_tpu_torch.ops import poh as PT
from firedancer_tpu_torch.ops import sha256 as ST
from test_torch_sha256 import host_chain, host_sha  # noqa: F401  (fixture)
from test_torch_verify_core import assert_no_sanitizer_report


def _append_ref(state: bytes, n: int) -> bytes:
    for _ in range(n):
        state = hashlib.sha256(state).digest()
    return state


def _entry_ref(start: bytes, hashcnt: int, mix: bytes, has: bool) -> bytes:
    st = _append_ref(start, max(hashcnt - int(has), 0))
    return hashlib.sha256(st + mix).digest() if has else st


@pytest.mark.parametrize("n", [0, 1, 17])
def test_append_n(n):
    rng = np.random.default_rng(n)
    state = rng.integers(0, 256, (3, 32), np.uint8)
    got = PT.append_n(state, n, device="cpu").numpy()
    for i in range(3):
        assert got[i].tobytes() == _append_ref(state[i].tobytes(), n)
    np.testing.assert_array_equal(got, np.asarray(jax.jit(lambda s: PJ.append_n(s, n))(state)))


def test_mixin():
    rng = np.random.default_rng(1)
    state = rng.integers(0, 256, (2, 2, 32), np.uint8)
    mix = rng.integers(0, 256, (2, 2, 32), np.uint8)
    got = PT.mixin(state, mix, device="cpu").numpy()
    assert got.shape == (2, 2, 32)
    np.testing.assert_array_equal(got, np.asarray(PJ.mixin(state, mix)))
    for s, m, g in zip(state.reshape(4, 32), mix.reshape(4, 32), got.reshape(4, 32)):
        assert g.tobytes() == hashlib.sha256(s.tobytes() + m.tobytes()).digest()


def _entries(seed, b, max_hashcnt):
    """b entries: hashcnt 0 and 1 with and without a mixin first, then
    random counts up to max_hashcnt."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, 256, (b, 32), np.uint8)
    mixins = rng.integers(0, 256, (b, 32), np.uint8)
    hashcnts = rng.integers(0, max_hashcnt + 1, b).astype(np.int32)
    has = rng.integers(0, 2, b).astype(bool)
    hashcnts[:4] = [0, 0, 1, 1]
    has[:4] = [True, False, True, False]
    return starts, hashcnts, mixins, has


def test_verify_entries_matches_jax_and_hashlib():
    starts, hashcnts, mixins, has = _entries(2, 12, 9)
    got = PT.verify_entries(starts, hashcnts, mixins, has, 9, device="cpu").numpy()
    np.testing.assert_array_equal(
        got, np.asarray(PJ.verify_entries(starts, hashcnts, mixins, has, 9)))
    for i in range(len(hashcnts)):
        assert got[i].tobytes() == _entry_ref(starts[i].tobytes(), int(hashcnts[i]),
                                              mixins[i].tobytes(), bool(has[i])), i


def test_verify_entries_links_a_chain():
    """Entries cut from one host chain: every end state is the next
    entry's start."""
    rng = np.random.default_rng(4)
    st = rng.integers(0, 256, 32, np.uint8).tobytes()
    starts, ends, hcs, mixes, has = [], [], [], [], []
    for i in range(6):
        hc, m, h = int(rng.integers(1, 8)), rng.integers(0, 256, 32, np.uint8).tobytes(), i % 2 == 0
        starts.append(st)
        st = _entry_ref(st, hc, m, h)
        ends.append(st)
        hcs.append(hc)
        mixes.append(m)
        has.append(h)
    as_arr = lambda bs: np.stack([np.frombuffer(b, np.uint8) for b in bs])  # noqa: E731
    got = PT.verify_entries(as_arr(starts), np.array(hcs), as_arr(mixes), np.array(has), 7,
                            device="cpu").numpy()
    np.testing.assert_array_equal(got, as_arr(ends))
    np.testing.assert_array_equal(got[:-1], as_arr(starts[1:]))


def test_verify_entries_rejects_hashcnt_above_bound():
    starts, hashcnts, mixins, has = _entries(3, 4, 5)
    hashcnts[2] = 6
    with pytest.raises(ValueError, match="exceeds max_hashcnt"):
        PT.verify_entries(starts, hashcnts, mixins, has, 5, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_hashcnt"):
        PJ.verify_entries(starts, hashcnts, mixins, has, 5)


@pytest.mark.parametrize("seed,b,max_hashcnt", [(5, 16, 11), (6, 40, 3)])
def test_chain_kernel_host_build_matches_jax(host_sha, capfd, seed, b, max_hashcnt):  # noqa: F811
    """fdt_poh_chain's host form on verify_entries' inputs as bytes (n_plain
    = hashcnt - has_mixin, so -1 for hashcnt 0 with a mixin) equals the
    JAX verify_entries."""
    starts, hashcnts, mixins, has = _entries(seed, b, max_hashcnt)
    n_plain = np.where(has, hashcnts - 1, hashcnts)
    got = host_chain(host_sha, starts, n_plain, mixins, has)
    want = np.asarray(PJ.verify_entries(starts, hashcnts, mixins, has, max_hashcnt))
    np.testing.assert_array_equal(got, want)
    assert_no_sanitizer_report(capfd)


def test_verify_entries_hands_the_kernel_bytes_and_counts(monkeypatch):
    """verify_entries calls poh_chain_bytes once, with the 32-byte states
    and mixins as given and n_plain made beside the caller's counts: no word
    tensor on the way to the kernel."""
    starts, hashcnts, mixins, has = _entries(7, 8, 5)
    calls = []
    real = ST.poh_chain_bytes

    def spy(state, n_plain, mixin, has_mixin):
        calls.append((state, n_plain, mixin, has_mixin))
        return real(state, n_plain, mixin, has_mixin)

    monkeypatch.setattr(ST, "poh_chain_bytes", spy)
    got = PT.verify_entries(starts, hashcnts, mixins, has, 5, device="cpu").numpy()
    assert len(calls) == 1
    state, n_plain, mixin, has_mixin = calls[0]
    assert state.dtype == mixin.dtype == torch.uint8 and state.shape == (8, 32)
    assert n_plain.dtype == torch.int32 and has_mixin.dtype == torch.bool
    np.testing.assert_array_equal(n_plain.numpy(), np.where(has, hashcnts - 1, hashcnts))
    np.testing.assert_array_equal(got, np.asarray(PJ.verify_entries(starts, hashcnts, mixins,
                                                                    has, 5)))
