"""Synthetic ingress load-generator tile.

A copy of firedancer_tpu/tiles/synth.py; the pool is signed by the
port's ops/ed25519/hostpath.py.  The duplicate-storm fault injection (and
its flood_dup_txns counter) waits for the port of the fault injector.
Port-only: the frag budget lives in a u64 word of a topology-wide shared
region (`release_region`), set to the constructor's `total` at boot and
read at every loop, so a harness releases frags by writing that word,
also when the tile runs in a child process where the parent's copy of
`total` is never seen.

Reference model: src/disco/verify/verify_synth_load.c (synthetic
sig-verify load with modeled failure rates) and the fddev bench txn
generator tiles (src/app/fddev/tiles/fd_benchg.c).  Pre-generates a pool
of genuinely-signed transactions at boot, then streams them through the
out link at full ring rate, optionally re-publishing duplicates and
corrupting a fraction of signatures so downstream verify/dedup tiles have
real work to reject.
"""

from __future__ import annotations

import numpy as np

from ..ballet import txn as T
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
# hostpath sign/public are bit-identical to golden's (parity-tested) and
# far faster
from ..ops.ed25519 import hostpath

from . import wire


def make_txn_pool(
    n_txns: int,
    *,
    n_signers: int = 4,
    n_accounts: int = 16,
    corrupt_frac: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build a pool of signed txns (+trailers) as dense rows.

    Returns (rows (n, LINK_MTU) u8, szs (n,) u16, good (n,) bool) where
    good[i] is False for txns whose signature was deliberately corrupted.
    """
    rng = np.random.default_rng(seed)
    signers = []
    for i in range(n_signers):
        sk = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        signers.append((sk, hostpath.public_from_secret(sk)))
    accounts = [
        rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        for _ in range(n_accounts)
    ]
    program = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()

    rows = np.zeros((n_txns, wire.LINK_MTU), dtype=np.uint8)
    szs = np.zeros(n_txns, dtype=np.uint16)
    good = np.ones(n_txns, dtype=bool)
    blockhash = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    for i in range(n_txns):
        sk, pk = signers[i % n_signers]
        extra = [accounts[j] for j in rng.choice(n_accounts, 2, replace=False)]
        addrs = [pk] + extra + [program]
        data = rng.integers(0, 256, rng.integers(8, 64), dtype=np.uint8).tobytes()
        body = T.build(
            [bytes(64)],
            addrs,
            blockhash,
            [(len(addrs) - 1, [0, 1, 2], data)],
            readonly_unsigned_cnt=1,
        )
        desc = T.parse(body)
        assert desc is not None
        msg = desc.message(body)
        sig = hostpath.sign(sk, msg)
        payload = body[:1] + sig + body[1 + 64 :]
        if corrupt_frac > 0 and rng.random() < corrupt_frac:
            b = bytearray(payload)
            b[1 + rng.integers(0, 64)] ^= 0xFF
            payload = bytes(b)
            good[i] = False
        full = wire.append_trailer(payload, desc)
        rows[i, : len(full)] = np.frombuffer(full, dtype=np.uint8)
        szs[i] = len(full)
    return rows, szs, good


#: a release word's "no budget": publish until halted
UNBOUNDED = (1 << 64) - 1


class SynthTile(Tile):
    """Streams a pre-signed txn pool; sig field = pool index tag."""

    schema = MetricsSchema(counters=("published_txns",))

    def __init__(
        self,
        rows: np.ndarray,
        szs: np.ndarray,
        *,
        total: int | None = None,
        repeat: int = 1,
        name: str = "synth",
    ):
        """Publish each pool entry `repeat` times (back to back batches),
        up to `total` frags overall (None = until halted): the word of the
        shared region `release_region` once booted."""
        self.name = name
        self._budget = None
        self.rows = rows
        self.szs = szs
        self.repeat = repeat
        self.total = total
        self.sent = 0
        # the dedup tag downstream tiles key on: first 8B of the ed25519
        # signature (reference: fd_verify.c publishes with this sig field)
        tr = wire.parse_trailers(rows, szs.astype(np.int64))
        n = len(rows)
        sig0 = rows[
            np.arange(n)[:, None], tr["sig_off"][:, None] + np.arange(8)
        ]
        self.tags = sig0.astype(np.uint64) @ (
            np.uint64(1) << (np.uint64(8) * np.arange(8, dtype=np.uint64))
        )

    @property
    def release_region(self) -> str:
        """The shared region whose u64 word is the synth's budget
        (UNBOUNDED: until halted)."""
        return f"{self.name}_release"

    def shared_wksp_footprints(self) -> dict[str, int]:
        return {self.release_region: 8}

    def on_boot(self, ctx: MuxCtx) -> None:
        self._budget = ctx.shared(self.release_region, 8).view(np.uint64)
        self._budget[0] = UNBOUNDED if self.total is None else self.total

    def after_credit(self, ctx: MuxCtx) -> None:
        word = int(self._budget[0])
        self.total = None if word == UNBOUNDED else word
        budget = ctx.credits
        if budget <= 0:
            return
        if self.total is not None:
            budget = min(budget, self.total - self.sent)
            if budget <= 0:
                return
        pool = len(self.rows)
        idx = (np.arange(self.sent, self.sent + budget) // self.repeat) % pool
        ctx.publish(self.tags[idx], self.rows[idx], self.szs[idx])
        self.sent += budget
        ctx.metrics.inc("published_txns", budget)
