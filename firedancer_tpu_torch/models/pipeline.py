"""The device ingress step: verify -> dedup -> pack prefilter, on one card or
over a dp x mp mesh of ranks.

The PyTorch counterpart of firedancer_tpu/models/pipeline.py:

  * verify: SHA-512 over R || A || M, the prologue, the verify_core kernel
    (ops/ed25519/verify.py), on this rank's dp slice of the batch;
  * dedup: an N_HASH-probe bloom membership test against current|previous
    of a double-buffered aging filter, a first-occurrence mask for repeats
    inside the batch, and inserts of verified first occurrences into
    current;
  * pack prefilter: the greedy conflict scan of ops/pack_select.py.

The filter is BLOOM_BITS = 2^28 bits per buffer, two buffers of 32 MiB each
resident on the card as int32 words holding the JAX filter's uint32 bit
patterns.  False positives drop a valid txn (never admit a duplicate);
AgingBloom rotates previous <- current once current has absorbed
AGE_CAPACITY misses.

Over a mesh (parallel/mesh.py: torch.distributed groups, NCCL on cards,
gloo on the CPU) the JAX step's collectives map as
  all_gather(tags2, ok over dp) -> all_gather_into_tensor on group_dp,
  psum(probe bits over mp)      -> all_reduce(SUM) on group_mp,
  psum(metrics[:3] over dp)     -> all_reduce(SUM) on group_dp;
metrics[3] is computed from gathered values, equal on every rank, so the
ranks' AgingBlooms rotate in step with no extra message.  Each rank owns
BLOOM_BITS // 32 // mp words of each buffer.  With no mesh every
collective is the identity.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import pack_select
from ..ops.ed25519 import golden
from ..ops.ed25519 import verify as fver
from ..utils import devices
from ..utils.hotpath import hot_path

#: bloom filter size in bits (power of two)
BLOOM_BITS = 1 << 28
#: hash probes per tag
N_HASH = 4
#: inserts before the host rotates the double buffer (reference tcache
#: depth, src/app/fdctl/config/default.toml:760)
AGE_CAPACITY = 4_194_302

_M32 = 0xFFFFFFFF


def fresh_bloom(device=None, mp: int = 1) -> torch.Tensor:
    """A zeroed dedup filter buffer, one mp rank's shard of it:
    (BLOOM_BITS // 32 // mp,) int32 words."""
    if BLOOM_BITS % (32 * mp):
        raise ValueError(f"mp {mp} does not divide the filter's words")
    return torch.zeros(
        BLOOM_BITS // 32 // mp, dtype=torch.int32, device=devices.resolve(device)
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


def _insert(cur, lw, off, mask):
    """-> a fresh copy of the filter shard `cur` with the probe bits
    (word lw, bit off) set where `mask`; `cur` itself is left untouched,
    as the JAX step leaves it, so a batch run twice on the same buffers
    (a pool's resubmit) gets the same answer twice.

    Duplicate bit indices are dropped by sorting; of the rest only bits
    still clear in `cur` are added, so the per-word sum of distinct clear
    bits that index_add_ forms equals their OR and never carries."""
    sent = cur.shape[0] * 32  # sorts after every real bit index
    lbit = torch.where(mask, (lw << 5) | off, sent).reshape(-1)
    sl, _ = torch.sort(lbit)
    valid = sl < sent
    valid[1:] &= sl[1:] != sl[:-1]
    word = torch.where(valid, sl >> 5, 0)
    bit = sl & 31
    clear = ((cur[word].to(torch.int64) >> bit) & 1) == 0
    val = torch.where(valid & clear, torch.ones_like(bit) << bit, 0)
    # as int32 bit patterns: 2^31 is -2^31
    val = torch.where(val >= 1 << 31, val - (1 << 32), val).to(torch.int32)
    new_cur = cur.clone()
    new_cur.index_add_(0, word, val)
    return new_cur


#: all_gather_into_tensor, renamed all_gather_single in newer torch
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather_dp(x, mesh):
    """all_gather over dp, tiled: (Bl, ...) -> (dp * Bl, ...) in dp order."""
    out = x.new_empty((mesh.dp * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=mesh.group_dp)
    return out


def make_step(device=None, mesh=None):
    """The ingress step on this card (default: the CUDA card), alone or as
    one rank of a dp x mp mesh (parallel/mesh.py's ProcessMesh).

    step(msgs, lens, sigs, pubs, tags2, cur, prev) takes this rank's dp
    slice of the batch: msgs (Bl, W) u8, lens (Bl,), sigs (Bl, 64) u8,
    pubs (Bl, 32) u8, tags2 (Bl, 2) u32 dedup tag words (numpy arrays or
    tensors), and its mp shard of the filter pair cur/prev ((BLOOM_BITS //
    32 // mp,) int32 tensors on the card).  It returns (keep (Bl,) bool, new
    current shard, metrics (4,) int32: [verified, failed, dup_hits,
    inserted] over the whole batch).  The new current shard is a fresh
    tensor and `cur` is left as it was (see dedup)."""
    dev = devices.resolve(device)

    @hot_path
    def step(msgs, lens, sigs, pubs, tags2, cur, prev):
        ok = fver.verify_batch(msgs, lens, sigs, pubs, device=dev)
        return dedup(ok, _as_tags(tags2, dev), cur, prev, mesh)

    step.device = dev
    return step


@hot_path
def dedup(ok, tags2, cur, prev, mesh=None):
    """The dedup half of the step, on verified lanes `ok` (Bl,) bool and
    tags2 (Bl, 2) int64 of this rank's dp slice, and its mp shard of the
    filter pair; see make_step for the outputs.  It reads cur and prev and
    writes neither: the new current shard is a fresh tensor (one copy of
    the shard per step), as the JAX step returns a fresh array."""
    if mesh is None:
        all_tags, all_ok, shard_lo, lo = tags2, ok, 0, 0
    else:
        all_tags = _gather_dp(tags2, mesh)
        all_ok = _gather_dp(ok.to(torch.uint8), mesh).bool()
        shard_lo = mesh.mp_index * cur.shape[0]
        lo = mesh.dp_index * tags2.shape[0]
    bits = _tag_bits(all_tags)  # (N_HASH, Bg)
    local = (bits >> 5) - shard_lo
    off = bits & 31
    in_shard = (local >= 0) & (local < cur.shape[0])
    lw = torch.where(in_shard, local, 0)
    probe = torch.where(
        in_shard, ((cur[lw] | prev[lw]).to(torch.int64) >> off) & 1, 0
    )
    if mesh is not None:
        dist.all_reduce(probe, group=mesh.group_mp)  # each bit 0/1
    hits = probe.amin(dim=0)  # bloom hit iff all probes set

    # membership reads the pre-insert filter, so repeats inside one batch
    # need their own first-occurrence mask
    first = _first_occurrence(all_tags)
    # insert verified first occurrences only: a failed signature must not
    # censor a later valid txn with the same tag
    insertable = all_ok & first
    new_cur = _insert(cur, lw, off, in_shard & insertable[None, :])

    bl = tags2.shape[0]
    keep = (all_ok & (hits == 0) & first)[lo : lo + bl]
    my_hits = hits[lo : lo + bl]
    m = torch.stack([ok.sum(), (~ok).sum(), (ok & (my_hits != 0)).sum()])
    if mesh is not None:
        dist.all_reduce(m, group=mesh.group_dp)
    # inserted counts misses only, so duplicate-heavy traffic does not
    # rotate the aging buffer early; from gathered values, so equal on
    # every rank
    inserted = (insertable & (hits == 0)).sum()
    metrics = torch.cat([m, inserted[None]]).to(torch.int32)
    return keep, new_cur, metrics


class AgingBloom:
    """Host-side owner of the double-buffered filter on the card, or of one
    mp rank's shard of it (`mp` shards; every rank of a mesh sees the same
    metrics[3], so the shards rotate in step).

    Once `cur` has absorbed `capacity` tags, previous <- current and
    current starts empty, so the filter remembers between capacity and
    2*capacity of the most recent tags."""

    def __init__(self, device=None, capacity: int = AGE_CAPACITY, mp: int = 1):
        self.device = devices.resolve(device)
        self.capacity = capacity
        self.cur = fresh_bloom(self.device, mp)
        self.prev = fresh_bloom(self.device, mp)
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
        capacity.  The new current buffer is a fresh zeroed tensor, as in
        the JAX AgingBloom: zeroing the old previous buffer in place would
        change a buffer the caller may still hold (to retry a step)."""
        self.cur = new_cur
        self.inserted += int(metrics[3])
        if self.inserted >= self.capacity:
            self.prev, self.cur = self.cur, torch.zeros_like(self.cur)
            self.inserted = 0
            self.rotations += 1


def pack_prefilter(cand_rw32, cand_w32, in_use_rw32, in_use_w32, costs,
                   cu_limit, txn_limit):
    """Pack-candidate selection on the card: the greedy scan of
    ops/pack_select.py (on CUDA tensors the pack_select kernel) over
    (K, W2) int32 bitset halves already on the device; -> (K,) bool take
    mask.  Same int32 budget validation as select_noconflict."""
    pack_select.check_cu_limit(cu_limit)
    return pack_select.select_impl(
        cand_rw32, cand_w32, in_use_rw32, in_use_w32,
        costs.to(torch.int64), int(cu_limit), int(txn_limit),
    )


# ---------------------------------------------------------------------------
# dry runs (parallel/dryrun.py runs them on every rank of a mesh)
# ---------------------------------------------------------------------------


def _dp_slice(mesh, batch: int) -> slice:
    """This rank's dp slice of a batch of `batch` lanes."""
    dp, i = (1, 0) if mesh is None else (mesh.dp, mesh.dp_index)
    if batch % dp:
        raise ValueError(f"batch {batch} does not split over dp {dp}")
    bl = batch // dp
    return slice(i * bl, (i + 1) * bl)


def _signed_slice(sk, pk, msgs, lens, lanes, n_real=None):
    """(sigs, pubs, tags2) of the lanes `lanes` (a slice): golden.sign of
    each message, zero signatures from lane n_real on (they fail verify)."""
    idx = range(msgs.shape[0])[lanes]
    sigs = np.zeros((len(idx), 64), np.uint8)
    for j, i in enumerate(idx):
        if n_real is None or i < n_real:
            sigs[j] = np.frombuffer(
                golden.sign(sk, msgs[i, : lens[i]].tobytes()), np.uint8)
    pubs = np.tile(np.frombuffer(pk, np.uint8), (len(idx), 1))
    return sigs, pubs, sigs[:, :8].copy().view(np.uint32).reshape(-1, 2)


def dryrun_step(mesh, msgs: np.ndarray, lens: np.ndarray, device=None) -> None:
    """One full step on this rank of `mesh` (None: one card) at the
    production filter size, then the same tags again, then the pack
    prefilter; the counterpart of the JAX dryrun_step.  msgs/lens are the
    whole batch; this rank signs and runs its dp slice."""
    dev = devices.resolve(device)
    B = msgs.shape[0]
    rng = np.random.default_rng(7)
    sk = rng.integers(0, 256, 32, np.uint8).tobytes()
    pk = golden.public_from_secret(sk)
    # lane 1 is an exact within-batch duplicate of lane 0: the step must
    # keep only the first occurrence
    msgs = msgs.copy()
    msgs[1] = msgs[0]
    sl = _dp_slice(mesh, B)
    sigs, pubs, tags2 = _signed_slice(sk, pk, msgs, lens, sl)
    args = (msgs[sl], lens[sl], sigs, pubs, tags2)

    bloom = AgingBloom(dev, mp=1 if mesh is None else mesh.mp)
    step = make_step(dev, mesh)
    keep, cur1, metrics = step(*args, *bloom.buffers())
    want = np.ones(B, bool)
    want[1] = False
    k0, m0 = keep.cpu().numpy(), metrics.cpu().numpy()
    assert np.array_equal(k0, want[sl]), "the within-batch duplicate must be dropped"
    assert m0[0] == B and m0[1] == 0, m0
    assert m0[3] == B - 1  # B txns, one within-batch duplicate
    bloom.update(cur1, metrics)

    # the same tags again: the filter must now reject all of them
    keep2, _, metrics2 = step(*args, *bloom.buffers())
    assert not keep2.cpu().numpy().any(), "duplicates must be dropped"
    assert int(metrics2[2]) == B  # every tag now hits the filter

    # pack prefilter (replicated on every rank)
    K, W2 = 16, 8
    cand_rw = rng.integers(0, 2**31, (K, W2)).astype(np.uint32)
    cand_w = cand_rw & rng.integers(0, 2**31, (K, W2)).astype(np.uint32)
    put = lambda a: torch.from_numpy(a.view(np.int32)).to(dev)  # noqa: E731
    zero = np.zeros(W2, np.uint32)
    take = pack_prefilter(put(cand_rw), put(cand_w), put(zero), put(zero),
                          torch.full((K,), 1000, dtype=torch.int64, device=dev),
                          1 << 20, 8)
    assert take.cpu().numpy().any()


def dryrun_sustained(mesh, steps: int = 6, device=None) -> int:
    """Several steps on this rank of `mesh` (None: one card): AgingBloom
    across two rotation boundaries (capacity = one batch), per-step metrics,
    an uneven (padded) final batch, and the aging semantics end to end:
    tags are remembered for one epoch after rotation and forgotten after
    two.  The counterpart of the JAX dryrun_sustained; -> rotations."""
    dev = devices.resolve(device)
    dp = 1 if mesh is None else mesh.dp
    B, W = 8 * dp, 64
    sl = _dp_slice(mesh, B)
    rng = np.random.default_rng(13)
    sk = rng.integers(0, 256, 32, np.uint8).tobytes()
    pk = golden.public_from_secret(sk)

    def batch(seed, n_real=B):
        r = np.random.default_rng(seed)
        msgs = r.integers(0, 256, size=(B, W), dtype=np.uint8)
        lens = np.full(B, W, np.int32)
        # lanes past n_real model an uneven final batch: zero signatures
        # fail verify, and the metrics must count them as failed
        sigs, pubs, tags2 = _signed_slice(sk, pk, msgs, lens, sl, n_real)
        return msgs[sl], lens[sl], sigs, pubs, tags2

    step = make_step(dev, mesh)
    bloom = AgingBloom(dev, capacity=1, mp=1 if mesh is None else mesh.mp)

    def run(b, update=True):
        keep, cur, metrics = step(*b, *bloom.buffers())
        if update:
            bloom.update(cur, metrics)
        return keep.cpu().numpy(), metrics.cpu().numpy()

    first = batch(100)
    keep, m = run(first)
    assert m[0] == B and m[1] == 0 and m[3] == B, m
    assert keep.all() and bloom.rotations == 1

    # epoch 1: the epoch-0 tags must still be remembered (membership
    # consults current|previous across the rotation boundary)
    keep, m = run(first)  # inserts 0 (all hits): no rotation
    assert not keep.any(), "post-rotation recall failed"
    assert bloom.rotations == 1

    for k in range(steps - 2):
        keep, m = run(batch(200 + k))
        assert m[0] + m[1] == B, m  # every lane accounted each step
        assert m[0] == B and m[3] == B, m
    assert bloom.rotations >= 3

    # two full epochs later the first batch's tags must be forgotten
    keep, m = run(first)
    assert keep.all(), "aged-out tags must be admitted again"

    # uneven final batch: only half the lanes carry real signed txns
    half = B // 2
    keep, m = run(batch(999, n_real=half), update=False)
    assert m[0] == half and m[1] == B - half, m
    assert np.array_equal(keep, (np.arange(B) < half)[sl])
    return bloom.rotations
