"""Runtime ring-ABI version handshake.

A copy of firedancer_tpu/disco/handshake.py, whole: `Handshake` (with
`approve`, part of the word layout though hot upgrade is not ported),
`check_join`, `HandshakeRefused` and `probe_digest`.  The digest is the
port's own (tango/rings.py abi_digest, over the port's ctypes table,
constants and cfg-word map), so it differs from the JAX package's; it is
stable across interpreters on one tree.

One tree's ctypes table, C prototypes and cfg-word constants agree with
each other by construction; a process-runtime child is a second
interpreter that may import another tree (or load another .so) against
rings the parent built.  This module makes that agreement a runtime
contract:

- `tango/rings.py abi_digest()` folds the incarnation's entire ring
  contract — native symbol set (the .so's .hsk sidecar from
  utils/cbuild.py), ctypes sigs table, ring/stem layout constants,
  cfg-word map, emit-body signatures — into one nonzero u64.
- `Topology.build()` allocates the `shared_handshake` region and writes
  the building tree's digest into it (single writer: the parent; a
  joiner only reads).
- EVERY process-runtime child compares its own digest against the shm
  word right after `Workspace.attach`, BEFORE binding a single ring
  (`check_join`).  Mismatch → `HandshakeRefused` carrying both digests;
  the child exits without touching ring memory.
- An operator who has proven two versions ring-compatible out of band
  can `approve()` the foreign digest into the compat table (8 slots);
  `compatible()` accepts either the primary word or any table entry.

Word layout (16 u64 words, 128 bytes):

    0  MAGIC
    1  DIGEST       the building tree's abi_digest()
    2  NCOMPAT      live entries in the compat table
    3..10           compat table slots
    11..15          spare
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np

HANDSHAKE_MAGIC = 0xF17EDA2CE57E0003
HANDSHAKE_FOOTPRINT = 128  # 16 u64 words

_W_MAGIC, _W_DIGEST, _W_NCOMPAT, _W_COMPAT0 = 0, 1, 2, 3
MAX_COMPAT = 8


class HandshakeRefused(RuntimeError):
    """A joining incarnation's ABI digest matched neither the workspace
    word nor any compat-table entry — refused before any ring bind."""

    def __init__(self, shm_digest: int, my_digest: int, tile: str = ""):
        self.shm_digest = shm_digest
        self.my_digest = my_digest
        self.tile = tile
        super().__init__(
            f"version handshake refused{f' for tile {tile!r}' if tile else ''}: "
            f"workspace ABI digest {shm_digest:#018x} vs joining "
            f"incarnation {my_digest:#018x} — mixed-version topology is "
            f"not proven ring-compatible (rebuild from the same tree, or "
            f"approve the digest via Handshake.approve after an "
            f"out-of-band compatibility proof)"
        )


class Handshake:
    """View of the shared_handshake region (owner or joiner)."""

    def __init__(self, mem_u8: np.ndarray, join: bool = True):
        self.words = mem_u8[: (len(mem_u8) // 8) * 8].view(np.uint64)
        if not join:
            self.words[_W_DIGEST] = 0
            self.words[_W_NCOMPAT] = 0
            # magic last: a joiner that sees it sees a full header
            self.words[_W_MAGIC] = np.uint64(HANDSHAKE_MAGIC)

    # -- owner (parent) side ------------------------------------------------

    def init(self, digest: int) -> None:
        assert digest != 0, "0 is the uninitialized-word sentinel"
        self.words[_W_DIGEST] = np.uint64(digest)

    def approve(self, digest: int) -> None:
        """Admit a foreign digest into the compat table (operator has
        proven the two versions ring-compatible out of band)."""
        if self.compatible(digest):
            return
        n = int(self.words[_W_NCOMPAT])
        assert n < MAX_COMPAT, "compat table full"
        # slot store first, count after: a concurrent reader never sees
        # a live count covering an unwritten slot
        self.words[_W_COMPAT0 + n] = np.uint64(digest)
        self.words[_W_NCOMPAT] = np.uint64(n + 1)

    # -- joiner side ---------------------------------------------------------

    def digest(self) -> int:
        return int(self.words[_W_DIGEST])

    def compatible(self, digest: int) -> bool:
        if int(self.words[_W_MAGIC]) != HANDSHAKE_MAGIC:
            return False
        if digest == self.digest():
            return True
        n = min(int(self.words[_W_NCOMPAT]), MAX_COMPAT)
        return any(
            int(self.words[_W_COMPAT0 + i]) == digest for i in range(n)
        )


def check_join(mem_u8: np.ndarray, my_digest: int, tile: str = "") -> None:
    """The joiner-side gate: raise HandshakeRefused unless `my_digest`
    is proven compatible with the workspace's handshake word.  Called
    by every rebind path after Workspace.attach and before any
    InLink/OutLink/ring construction."""
    hs = Handshake(mem_u8, join=True)
    if not hs.compatible(my_digest):
        raise HandshakeRefused(hs.digest(), my_digest, tile=tile)


# ---------------------------------------------------------------------------
# version probing

_PROBE_CACHE: dict[str, int] = {}


def probe_digest(version_root: str | None = None,
                 so_path: str | None = None) -> int:
    """The abi_digest a child importing firedancer_tpu_torch from
    `version_root` would compute.  Identity (no root) answers
    in-process; a foreign tree is probed in a throwaway interpreter with
    that tree first on sys.path, cached per root.  A prebuilt native
    artifact (`so_path`) belongs to hot upgrade, which is not ported."""
    if so_path is not None:
        raise NotImplementedError(
            "probe_digest(so_path=): loading a prebuilt ring library is "
            "part of hot upgrade (disco/elastic.py), not ported yet"
        )
    if version_root is None:
        from ..tango import rings as R

        return R.abi_digest()
    if version_root in _PROBE_CACHE:
        return _PROBE_CACHE[version_root]
    code = (
        f"import sys; sys.path.insert(0, {version_root!r}); "
        "import firedancer_tpu_torch.tango.rings as r; print(r.abi_digest())"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300,
    )
    if out.returncode != 0:
        raise RuntimeError(
            f"version probe failed for root={version_root!r}:\n{out.stderr}"
        )
    d = int(out.stdout.strip().splitlines()[-1])
    _PROBE_CACHE[version_root] = d
    return d
