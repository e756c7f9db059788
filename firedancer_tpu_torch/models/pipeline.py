"""The device ingress step on one card: verify -> dedup -> pack prefilter.

The single-card PyTorch counterpart of firedancer_tpu/models/pipeline.py
(dp = mp = 1, so every collective of the JAX step is the identity):

  * verify: SHA-512 over R || A || M, the prologue, the verify_core kernel
    (ops/ed25519/verify.py);
  * dedup: an N_HASH-probe bloom membership test against current|previous
    of a double-buffered aging filter, a first-occurrence mask for repeats
    inside the batch, and inserts of verified first occurrences into
    current;
  * pack prefilter: the greedy conflict scan of ops/pack_select.py.

The filter is BLOOM_BITS = 2^28 bits per buffer, two buffers of 32 MiB each
resident on the card as int32 words holding the JAX filter's uint32 bit
patterns.  False positives drop a valid txn (never admit a duplicate);
AgingBloom rotates previous <- current once current has absorbed
AGE_CAPACITY misses.  The multi-card (dp x mp) step is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import pack_select
from ..ops.ed25519 import verify as fver
from ..utils import devices

#: bloom filter size in bits (power of two)
BLOOM_BITS = 1 << 28
#: hash probes per tag
N_HASH = 4
#: inserts before the host rotates the double buffer (reference tcache
#: depth, src/app/fdctl/config/default.toml:760)
AGE_CAPACITY = 4_194_302

_M32 = 0xFFFFFFFF


def fresh_bloom(device=None) -> torch.Tensor:
    """A zeroed dedup filter buffer: (BLOOM_BITS // 32,) int32 words."""
    return torch.zeros(
        BLOOM_BITS // 32, dtype=torch.int32, device=devices.resolve(device)
    )


def _mulc(x, c: int):
    """x * c mod 2^32 for x in [0, 2^32) held in int64, without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mulc(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mulc(x, 0x846CA68B)
    return x ^ (x >> 16)


def _tag_bits(tags2):
    """(B, 2) tag words in [0, 2^32) (int64) -> (N_HASH, B) int64 bit
    indices by double hashing: bit_i = (h1 + i*h2) mod BLOOM_BITS, h2 odd."""
    lo, hi = tags2[:, 0], tags2[:, 1]
    h1 = _mix(lo ^ _mix(hi))
    h2 = _mix((hi + 0x9E3779B9) & _M32) | 1
    i = torch.arange(N_HASH, dtype=torch.int64, device=tags2.device)[:, None]
    return (h1[None, :] + i * h2[None, :]) & (BLOOM_BITS - 1)


def _as_tags(tags2, dev) -> torch.Tensor:
    """(B, 2) uint32 tag words (numpy or tensor) -> int64 tensor on dev."""
    if not isinstance(tags2, torch.Tensor):
        tags2 = torch.from_numpy(np.asarray(tags2, np.uint32).astype(np.int64))
    return tags2.to(device=dev, dtype=torch.int64)


def _first_occurrence(tags2):
    """(B,) bool: the lane is the first in the batch with its tag."""
    key = (tags2[:, 1] << 32) | tags2[:, 0]  # the 64-bit tag, bijectively
    st, order = torch.sort(key, stable=True)
    head = torch.ones_like(st, dtype=torch.bool)
    head[1:] = st[1:] != st[:-1]
    first = torch.empty_like(head)
    first[order] = head
    return first


def _insert(cur, bits, insertable):
    """OR the probe bits of insertable lanes into `cur`, in place.

    Duplicate bit indices are dropped by sorting; of the rest only bits
    still clear in `cur` are added, so the per-word sum of distinct clear
    bits that index_add_ forms equals their OR and never carries."""
    sent = BLOOM_BITS  # sorts after every real bit index
    lbit = torch.where(insertable[None, :], bits, sent).reshape(-1)
    sl, _ = torch.sort(lbit)
    valid = sl < sent
    valid[1:] &= sl[1:] != sl[:-1]
    word = torch.where(valid, sl >> 5, 0)
    bit = sl & 31
    clear = ((cur[word].to(torch.int64) >> bit) & 1) == 0
    val = torch.where(valid & clear, torch.ones_like(bit) << bit, 0)
    # as int32 bit patterns: 2^31 is -2^31
    val = torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)
    cur.index_add_(0, word, val)


def make_step(device=None):
    """The ingress step for one card (default: the CUDA card).

    step(msgs, lens, sigs, pubs, tags2, cur, prev) takes msgs (B, W) u8,
    lens (B,), sigs (B, 64) u8, pubs (B, 32) u8, tags2 (B, 2) u32 dedup
    tag words (numpy arrays or tensors) and the filter pair cur/prev
    ((BLOOM_BITS // 32,) int32 tensors on the card).  It returns (keep (B,)
    bool, new current buffer, metrics (4,) int32: [verified, failed,
    dup_hits, inserted]).  The new current buffer is `cur` itself, updated
    in place (the JAX step returns a fresh array; in place saves a 32 MiB
    copy per step)."""
    dev = devices.resolve(device)

    def step(msgs, lens, sigs, pubs, tags2, cur, prev):
        ok = fver.verify_batch(msgs, lens, sigs, pubs, device=dev)
        return dedup(ok, _as_tags(tags2, dev), cur, prev)

    step.device = dev
    return step


def dedup(ok, tags2, cur, prev):
    """The dedup half of the step, on verified lanes `ok` (B,) bool and
    tags2 (B, 2) int64; see make_step for the outputs."""
    bits = _tag_bits(tags2)  # (N_HASH, B)
    word, off = bits >> 5, bits & 31
    probe = ((cur[word] | prev[word]).to(torch.int64) >> off) & 1
    hits = probe.amin(dim=0)  # bloom hit iff all probes set

    # membership reads the pre-insert filter, so repeats inside one batch
    # need their own first-occurrence mask
    first = _first_occurrence(tags2)
    # insert verified first occurrences only: a failed signature must not
    # censor a later valid txn with the same tag
    insertable = ok & first
    _insert(cur, bits, insertable)

    keep = ok & (hits == 0) & first
    metrics = torch.stack(
        [
            ok.sum(),
            (~ok).sum(),
            (ok & (hits != 0)).sum(),
            # inserted counts misses only, so duplicate-heavy traffic does
            # not rotate the aging buffer early
            (insertable & (hits == 0)).sum(),
        ]
    ).to(torch.int32)
    return keep, cur, metrics


class AgingBloom:
    """Host-side owner of the double-buffered filter on the card.

    Once `cur` has absorbed `capacity` tags, previous <- current and
    current is zeroed, so the filter remembers between capacity and
    2*capacity of the most recent tags."""

    def __init__(self, device=None, capacity: int = AGE_CAPACITY):
        self.device = devices.resolve(device)
        self.capacity = capacity
        self.cur = fresh_bloom(self.device)
        self.prev = fresh_bloom(self.device)
        self.inserted = 0
        self.rotations = 0

    @classmethod
    def from_numpy(cls, cur, prev, inserted: int = 0, rotations: int = 0,
                   device=None, capacity: int = AGE_CAPACITY):
        """Adopt a JAX AgingBloom's buffers (np.asarray(bloom.cur), uint32
        words) bit for bit."""
        self = cls.__new__(cls)
        self.device = devices.resolve(device)
        self.capacity = capacity
        self.cur, self.prev = (
            torch.from_numpy(
                np.ascontiguousarray(a, np.uint32).view(np.int32).copy()
            ).to(self.device)
            for a in (cur, prev)
        )
        self.inserted = int(inserted)
        self.rotations = int(rotations)
        return self

    def to_numpy(self):
        """-> (cur, prev) as uint32 numpy words, inserted, rotations."""
        cur, prev = (
            t.cpu().numpy().view(np.uint32) for t in (self.cur, self.prev)
        )
        return cur, prev, self.inserted, self.rotations

    def buffers(self):
        return self.cur, self.prev

    def update(self, new_cur, metrics) -> None:
        """Adopt the step's output filter and count inserts; rotate at
        capacity (the old previous buffer is zeroed and becomes current)."""
        self.cur = new_cur
        self.inserted += int(metrics[3])
        if self.inserted >= self.capacity:
            old_prev = self.prev
            self.prev = self.cur
            self.cur = old_prev.zero_()
            self.inserted = 0
            self.rotations += 1


def pack_prefilter(cand_rw32, cand_w32, in_use_rw32, in_use_w32, costs,
                   cu_limit, txn_limit):
    """Pack-candidate selection on the card: the greedy scan of
    ops/pack_select.py over (K, W2) int32 bitset halves already on the
    device; -> (K,) bool take mask.  Same int32 budget validation as
    select_noconflict."""
    pack_select.check_cu_limit(cu_limit)
    return pack_select.select_impl(
        cand_rw32, cand_w32, in_use_rw32, in_use_w32,
        costs.to(torch.int64), int(cu_limit), int(txn_limit),
    )
