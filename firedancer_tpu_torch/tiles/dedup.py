"""Dedup tile: drops transactions whose signature tag was already seen.

A copy of firedancer_tpu/tiles/dedup.py without the native stem handler
(the stem is not ported yet).

Reference model: src/app/fdctl/run/tiles/fd_dedup.c — a single tile
downstream of all verify tiles applying one FD_TCACHE_INSERT per frag on
the tango sig field (first 8 bytes of the ed25519 signature), with a
multi-million-entry tag cache (default 4,194,302,
src/app/fdctl/config/default.toml:760).  Here the whole drained batch is
deduped in one native call (fdt_tcache_dedup_j) and survivors are
forwarded in one scatter+publish.

Exactly-once across restarts: the tag cache lives in
shm and survives a crash, which is what collapses the supervisor's
reliable-link replay back to exactly-once — but it also opened a LOSS
window: a tile killed between the tcache insert and the downstream
publish left its batch's survivors in the cache, so the replay was
filtered as duplicates and the frags were gone (observed as rare
lost-frag flakes in the process-runtime kill/restart chaos test).

The insert is now journaled and recovery is itself crash-safe:

  * fdt_tcache_dedup_j appends every inserted tag to the ACTIVE journal
    slot (shm) BEFORE the insert becomes visible;
  * when the survivor list diverges from the inserted list (an amnesty
    hit, or a zero-tag pass-through survivor), the full survivor list
    is written to the INACTIVE slot and the active index flips with one
    store — a kill mid-rewrite recovers from the still-consistent old
    slot (plus the amnesty area), never a half-written list;
  * a restarted incarnation grants the journaled-but-unpublished tags a
    one-shot replay AMNESTY (metered as `replay_amnesty`): how many
    were published is derived from the out mcache's repaired sequence,
    so the amnesty can neither lose nor duplicate;
  * the amnesty set itself persists in a shm area until each tag is
    re-seen (it is absorbed into the next batch's journal before its
    publish), so a SECOND crash before the replay drains still
    recovers.
"""

from __future__ import annotations

import numpy as np

from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
from ..tango import rings as R

#: journal header u64 words
_J_PHASE, _J_SEQ0, _J_ACTIVE, _J_ACNT = 0, 1, 2, 3
_J_SLOT0 = 8
#: within a slot block (C contract, tango/native fdt_tcache_dedup_j):
#: [2] count, [3] overflow, tags from [4]; [0]/[1] unused
_B_CNT, _B_OVF, _B_TAGS = 2, 3, 4


class DedupTile(Tile):
    schema = MetricsSchema(
        counters=("dup_txns", "replay_amnesty", "amnesty_dropped")
    )

    #: max journaled inserts per drain batch; on_frags chunks bigger
    #: batches so the journal can never silently overflow
    JOURNAL_TAGS = 1 << 15
    #: the persistent amnesty area holds a full crashed batch PLUS
    #: leftovers a repeated-crash recovery merged in; overflow past
    #: this is metered (`amnesty_dropped`), never silent
    AMNESTY_TAGS = 2 * JOURNAL_TAGS

    _BLK = 4 + JOURNAL_TAGS  # words per journal slot block
    _J_WORDS = _J_SLOT0 + 2 * _BLK + AMNESTY_TAGS

    def __init__(self, *, depth: int = 1 << 22, name: str = "dedup"):
        self.name = name
        self.depth = depth
        self._tc: R.TCache | None = None
        self._jnl: np.ndarray | None = None
        self._blk = (None, None)  # journal slot block views
        self._area: np.ndarray | None = None
        self._amnesty: set[int] = set()
        #: test hook: called between the journaled insert and the
        #: publish to exercise the crash window deterministically
        self._crash_probe = None

    def wksp_footprint(self) -> int:
        return (
            R.TCache.footprint(self.depth, R.TCache.map_cnt_for(self.depth))
            + self._J_WORDS * 8
            + 256
        )

    def on_boot(self, ctx: MuxCtx) -> None:
        map_cnt = R.TCache.map_cnt_for(self.depth)
        fp = R.TCache.footprint(self.depth, map_cnt)
        # restart semantics: REJOIN the existing tag cache instead of
        # re-initializing it.  The supervisor replays reliable in-links
        # across a restart (at-least-once); the surviving history is
        # exactly what collapses that replay back to exactly-once — a
        # fresh cache here would re-admit every replayed txn downstream.
        self._tc = R.TCache(
            ctx.alloc("tcache", fp), self.depth, map_cnt,
            join=ctx.incarnation > 0,
        )
        jw = ctx.alloc("dedup_jnl", self._J_WORDS * 8)[
            : self._J_WORDS * 8
        ].view(np.uint64)
        self._jnl = jw
        blk = self._BLK
        self._blk = (
            jw[_J_SLOT0 : _J_SLOT0 + blk],
            jw[_J_SLOT0 + blk : _J_SLOT0 + 2 * blk],
        )
        self._area = jw[_J_SLOT0 + 2 * blk :]
        self._amnesty = set()
        # journaling assumes the single-out dedup shape (out-seq names
        # how much of the batch was published); anything else keeps the
        # pre-journal behavior
        if len(ctx.outs) != 1:
            self._jnl = None
            return
        # pending amnesty from an earlier recovery that never fully
        # drained (a second crash must not lose it)
        amn = {int(t) for t in self._area[: int(jw[_J_ACNT])]}
        if int(jw[_J_PHASE]) == 1:
            # died inside the window: the first k journaled survivors
            # made it out (the producer-rejoin repair already completed
            # any interrupted publish), the rest get a one-shot amnesty
            b = self._blk[int(jw[_J_ACTIVE]) & 1]
            cnt = min(int(b[_B_CNT]), self.JOURNAL_TAGS)
            k = R.seq_diff(
                ctx.outs[0].mcache.seq_query(), int(jw[_J_SEQ0])
            )
            k = min(max(k, 0), cnt)
            amn |= {int(t) for t in b[_B_TAGS + k : _B_TAGS + cnt]}
        amn.discard(0)
        self._amnesty = amn
        # persist the merged set BEFORE clearing the phase: recovery
        # state must survive a crash of the recovering incarnation too
        self._persist_amnesty(ctx)
        jw[_J_PHASE] = 0
        if ctx.incarnation > 0 and amn:
            ctx.metrics.inc("replay_amnesty", len(amn))

    def _persist_amnesty(self, ctx: MuxCtx) -> None:
        """Mirror the in-memory amnesty set into its shm area (tags
        first, count last).  Entries only ever leave the area after
        being absorbed into the next batch's journal, which happens
        before that batch publishes — so a kill at any point leaves the
        union of area + active journal covering every pending tag.
        Overflow past the area (requires back-to-back crashed 32K
        batches that never drained) is metered, never silent."""
        jw = self._jnl
        tags = list(self._amnesty)
        if len(tags) > self.AMNESTY_TAGS:
            ctx.metrics.inc(
                "amnesty_dropped", len(tags) - self.AMNESTY_TAGS
            )
            tags = tags[: self.AMNESTY_TAGS]
        if tags:
            self._area[: len(tags)] = np.array(tags, np.uint64)
        jw[_J_ACNT] = len(tags)

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        # never outgrow the crash journal: an over-capacity batch would
        # insert tags the journal cannot describe, silently reopening
        # the loss window for exactly the frags past the cap — chunking
        # keeps every insert recoverable at a cost only paid by batches
        # larger than 32K frags
        if self._jnl is not None and len(frags) > self.JOURNAL_TAGS:
            for lo in range(0, len(frags), self.JOURNAL_TAGS):
                self._process(ctx, in_idx, frags[lo : lo + self.JOURNAL_TAGS])
            return
        self._process(ctx, in_idx, frags)

    def _process(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        jw = self._jnl
        if jw is not None:
            # arm the journal BEFORE the insert mutates the shm cache:
            # slot 0 zeroed + seq0 first, phase last (a kill sees either
            # a clean journal or a fully-described window)
            b0 = self._blk[0]
            jw[_J_ACTIVE] = 0
            b0[_B_CNT] = 0
            b0[_B_OVF] = 0
            jw[_J_SEQ0] = ctx.outs[0].mcache.seq_query()
            jw[_J_PHASE] = 1
            dup = self._tc.dedup_j(frags["sig"], b0)
        else:
            dup = self._tc.dedup(frags["sig"])
        sigs = frags["sig"]
        fired = False
        consumed = False
        if self._amnesty:
            # one-shot pass for tags a dead incarnation inserted but
            # never published: the replayed original goes through once.
            # Grants are consumed ON SIGHT, dup or not — a replay that
            # arrives not-dup (the tcache ring evicted the tag meanwhile)
            # forwards normally, and a grant left behind would let one
            # genuine future duplicate through.
            for i in range(len(sigs)):
                s = int(sigs[i])
                if s in self._amnesty:
                    self._amnesty.discard(s)
                    consumed = True
                    if dup[i]:
                        dup[i] = False
                        fired = True
        n_dup = int(dup.sum())
        if n_dup:
            ctx.metrics.inc("dup_txns", n_dup)
        keep = ~dup
        if not keep.any():
            if jw is not None:
                jw[_J_PHASE] = 0
            return
        surv = sigs[keep]
        if jw is not None and (fired or not surv.all()):
            # the publish order diverges from the inserted-tag journal
            # (amnestied frags publish without a fresh insert; zero-tag
            # frags pass through unjournaled), so the out-seq -> journal
            # mapping needs the FULL survivor list.  Write it to the
            # inactive slot and flip with one store — a kill mid-write
            # recovers from the still-consistent slot 0 + amnesty area.
            b1 = self._blk[1]
            n_surv = len(surv)  # <= JOURNAL_TAGS (chunked above)
            b1[_B_TAGS : _B_TAGS + n_surv] = surv
            b1[_B_CNT] = n_surv
            jw[_J_ACTIVE] = 1
        if consumed and jw is not None:
            # consumed entries are now covered by the active journal
            # until published; shrink the persistent area (strictly
            # BEFORE the publish, so a stale area entry can never
            # coexist with a published frag)
            self._persist_amnesty(ctx)
        if self._crash_probe is not None:
            self._crash_probe()
        il = ctx.ins[in_idx]
        rows = il.gather(frags[keep])
        ctx.publish(
            surv, rows, frags["sz"][keep],
            tsorigs=frags["tsorig"][keep],
        )
        if jw is not None:
            jw[_J_PHASE] = 0
