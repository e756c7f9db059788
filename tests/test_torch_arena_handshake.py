"""The process runtime's shared-memory contracts in the port against the
JAX package's: WkspArena (a tile's named sub-allocator with its name table
in the region) lays out the same bytes and each package reads the other's
arena; the handshake words (check_join, approve, compatible) behave alike
on raw words; digest_of folds one components document to the same word;
the port's abi_digest is stable across two interpreters on one tree; and
utils/cbuild.py writes the .hsk ABI sidecar beside a library it builds."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from firedancer_tpu.disco import handshake as HJ
from firedancer_tpu.tango import rings as RJ
from firedancer_tpu.utils import cbuild as CBJ
from firedancer_tpu_torch.disco import handshake as HT
from firedancer_tpu_torch.tango import rings as RT
from firedancer_tpu_torch.utils import cbuild as CBT

ROOT = Path(__file__).resolve().parent.parent

#: (name, footprint) allocations, with a repeat (idempotent rejoin)
ALLOCS = [("dedup_tcache", 4096), ("sink_siglog", 8 * 65), ("bank0_bankjnl", 256),
          ("dedup_tcache", 4096), ("x" * 40, 1)]


def _drive(A, mem):
    """Owner allocations, then a rejoining owner and a reader."""
    a = A(mem, max_entries=8)
    views = [a.alloc(n, fp) for n, fp in ALLOCS]
    for v, (n, fp) in zip(views, ALLOCS):
        v[:] = (len(n) + fp) & 0xFF
    again = A(mem)  # a restarted owner finds the magic and rejoins
    assert again.capacity == 8 and again.names() == a.names()
    return [again.alloc(n, fp) for n, fp in ALLOCS[:3]]


def test_arena_bytes_match_jax():
    fp = RT.WkspArena.footprint(9000, 8)
    assert fp == RJ.WkspArena.footprint(9000, 8)
    assert RT.WkspArena.MAGIC == RJ.WkspArena.MAGIC
    mt, mj = np.zeros(fp, np.uint8), np.zeros(fp, np.uint8)
    vt, vj = _drive(RT.WkspArena, mt), _drive(RJ.WkspArena, mj)
    assert mt.tobytes() == mj.tobytes()
    assert [v.ctypes.data - mt.ctypes.data for v in vt] == \
        [v.ctypes.data - mj.ctypes.data for v in vj]


def test_arena_each_package_reads_the_others():
    fp = RT.WkspArena.footprint(9000, 8)
    for Owner, Reader in ((RJ.WkspArena, RT.WkspArena), (RT.WkspArena, RJ.WkspArena)):
        mem = np.zeros(fp, np.uint8)
        _drive(Owner, mem)
        r = Reader(mem, join=True)
        assert r.names() == ["dedup_tcache", "sink_siglog", "bank0_bankjnl", "x" * 40]
        assert int(r.view("sink_siglog")[0]) == (len("sink_siglog") + 8 * 65) & 0xFF
        with pytest.raises(KeyError):
            r.view("absent")


@pytest.mark.parametrize("A", [RT.WkspArena, RJ.WkspArena], ids=["port", "jax"])
def test_arena_refusals(A):
    mem = np.zeros(A.footprint(256, 2), np.uint8)
    with pytest.raises(RuntimeError, match="not initialized"):
        A(mem, join=True)  # join before the owner's init
    assert not mem.any()  # the reader wrote nothing
    a = A(mem, max_entries=2)
    a.alloc("a", 8)
    with pytest.raises(ValueError, match="realloc"):
        a.alloc("a", 16)
    with pytest.raises(ValueError, match="too long"):
        a.alloc("y" * 41, 8)
    a.alloc("b", 8)
    with pytest.raises(MemoryError, match="name table full"):
        a.alloc("c", 8)


def test_handshake_words_match_jax():
    assert (HT.HANDSHAKE_MAGIC, HT.HANDSHAKE_FOOTPRINT, HT.MAX_COMPAT) == \
        (HJ.HANDSHAKE_MAGIC, HJ.HANDSHAKE_FOOTPRINT, HJ.MAX_COMPAT)
    rng = np.random.default_rng(8)
    digests = [int(d) | 1 for d in rng.integers(1, 2**63, 12, dtype=np.int64)]
    mt = np.full(HT.HANDSHAKE_FOOTPRINT, 0xAB, np.uint8)
    mj = mt.copy()
    # before init: every join is refused (no magic)
    for H, m in ((HT, mt), (HJ, mj)):
        with pytest.raises(H.HandshakeRefused):
            H.check_join(m, digests[0])
    ht, hj = HT.Handshake(mt, join=False), HJ.Handshake(mj, join=False)
    ht.init(digests[0])
    hj.init(digests[0])
    for d in digests[1:9]:
        ht.approve(d)
        hj.approve(d)
    ht.approve(digests[3])  # already compatible: no new slot
    hj.approve(digests[3])
    assert mt.tobytes() == mj.tobytes()
    for d in digests + [12345]:
        assert HT.Handshake(mt).compatible(d) == HJ.Handshake(mj).compatible(d)
        refused = []
        for H, m in ((HT, mt), (HJ, mj)):
            try:
                H.check_join(m, d, tile="verify0")
                refused.append(None)
            except H.HandshakeRefused as e:
                refused.append((e.shm_digest, e.my_digest, e.tile, str(e).split(" — ")[0]))
        assert refused[0] == refused[1]
    with pytest.raises(AssertionError, match="full"):
        ht.approve(digests[9])
    with pytest.raises(AssertionError, match="full"):
        hj.approve(digests[9])


def test_digest_of_matches_jax():
    doc = {"c": ["int fdt_x(void * a)"], "sigs": {"fdt_x": ["c_int", ["c_void_p"]]},
           "cfg_words": {"CHUNK_SZ": 64, "STEM_H_DEDUP": 1}, "emit": {}}
    assert RT.digest_of(doc) == RJ.digest_of(doc)
    assert RT.digest_of(doc) & 1 and RT.digest_of(doc) != RT.digest_of({**doc, "emit": {"a": 1}})
    comp = RT.abi_components()
    assert sorted(comp) == sorted(RJ.abi_components()) == ["c", "cfg_words", "emit", "sigs"]
    # the port's own tree: its bound symbols are all exported by its sources
    names = {s.split("(")[0].split()[-1] for s in comp["c"]}
    assert set(comp["sigs"]) <= names and set(comp["emit"]) <= set(comp["sigs"])
    assert RT.abi_digest() == RT.digest_of(comp) == HT.probe_digest()


def test_abi_digest_stable_across_interpreters():
    code = "import firedancer_tpu_torch.tango.rings as r; print(r.abi_digest())"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    got = [subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
           for _ in range(2)]
    assert all(g.returncode == 0 for g in got), got[0].stderr[-2000:]
    assert {int(g.stdout.split()[-1]) for g in got} == {RT.abi_digest()}
    # a version root probes in its own interpreter: this tree gives this digest
    assert HT.probe_digest(str(ROOT)) == RT.abi_digest()
    with pytest.raises(NotImplementedError, match="hot upgrade"):
        HT.probe_digest(so_path="/nonexistent.so")


def test_cbuild_writes_the_abi_sidecar(tmp_path, monkeypatch):
    src = tmp_path / "fdt_demo.c"
    src.write_text(
        "#include <stdint.h>\n"
        "static int helper(int a) { return a; }\n"
        "uint64_t fdt_demo_sum(uint64_t const * a,\n"
        "                      uint64_t n) {\n"
        "  uint64_t s = 0; for (uint64_t i = 0; i < n; i++) s += a[i];\n"
        "  return s + (uint64_t)helper(0);\n}\n"
        "void fdt_demo_nop(void) {}\n")
    monkeypatch.setattr(CBT, "BUILD", tmp_path / "build")
    so = CBT.build("demo", [src])
    side = CBT.read_sidecar(so)
    assert CBT.sidecar_path(so) == Path(str(so) + ".hsk")
    assert side == {"symbols": CBJ.abi_symbols([src])}
    assert side["symbols"] == ["uint64_t fdt_demo_sum(uint64_t const * a, uint64_t n)",
                               "void fdt_demo_nop(void)"]
    # a cached library without its sidecar gets one back at the next build
    CBT.sidecar_path(so).unlink()
    assert CBT.build("demo", [src]) == so and CBT.read_sidecar(so) == side
    # the ring library's sidecar parses the port's own sources as JAX's would
    assert CBT.abi_symbols(RT._NATIVE_SOURCES) == CBJ.abi_symbols(RT._NATIVE_SOURCES)
