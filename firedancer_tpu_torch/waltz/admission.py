"""Ingress admission control, stake-weighted QoS, and load shedding.

A copy of firedancer_tpu/waltz/admission.py.  StakeTable.synthetic draws
from the port's copy of ballet/chacha20.py and orders with
`sorted_stake_weights`, a copy of firedancer_tpu/flamenco/leaders.py's.

Reference model: fd_quic's connection quotas + the reference's
stake-weighted TPU ingress policy (Solana QUIC admits connections and
streams by validator stake; unstaked traffic rides a best-effort
quota).  This module is the policy layer the wire edge (waltz/quic.py
QuicServer + tiles/quic.py QuicIngressTile) consults on every admission
decision:

  * `TokenBucket`       integer tick-domain rate limiter (no floats on
                        the hot path, no wall-clock reads — the owner
                        passes `now` from tango.tempo.tickcount()).
  * `ConnAdmission`     connection-level defense: global + per-source
                        connection caps, handshake-rate limiting (the
                        rejection signals backoff via a stateless
                        Retry), idle / never-completed-handshake
                        eviction bookkeeping, and per-connection txn
                        token buckets.
  * `StakeTable`        source identity -> stake weight, the QoS input.
                        Seeded from the same stake machinery the leader
                        schedule uses (flamenco/leaders.py ordering,
                        ballet/chacha20 rng for synthetic tables).
  * `LoadShedder`       explicit degradation levels driven by live
                        backpressure (backlog occupancy) and the SLO
                        burn-rate engine (disco/slo.py writes a
                        commanded level into the shared `shed` region):

                            L0 admit-all
                            L1 shed-unstaked        (unstaked txns drop)
                            L2 shed-lowstake        (+ low-stake drops)
                            L3 emergency-staked-only (+ unstaked conn
                               handshakes refused outright)

Every rejection is a METERED DROP with a reason code from `REASONS`
(each is a counter in the quic tile's schema) — never an exception out
of the tile loop, so a flood dies at the edge as bookkeeping, not as a
crash or an unbounded queue.

Clock discipline: every method that needs time takes `now` in the
tickcount domain (ns).  This module must never read time.* itself —
the fdtlint `hot-path-clock` rule polices all Admission/Shed/Bucket/
StakeTable classes repo-wide (these methods run inside on_frags /
after_credit hot paths).
"""

from __future__ import annotations

from dataclasses import dataclass

#: ticks per second in the tango.tempo.tickcount domain (ns on this host)
TICKS_PER_S = 1_000_000_000

#: drop-reason codes == the quic tile's counter names, so metering a
#: rejection is ctx.metrics.inc(reason) and the ledger invariant
#: "offered == admitted + sum(drops)" is readable straight off a
#: monitor snapshot
REASONS = (
    "drop_conn_cap",        # global live-connection cap
    "drop_source_cap",      # per-source-IP connection cap
    "drop_handshake_rate",  # handshake token bucket empty (Retry sent)
    "drop_emergency",       # L3: unstaked source refused outright
    "drop_txn_rate",        # per-connection txn token bucket empty
    "shed_unstaked",        # level gate: unstaked txn shed (L1+)
    "shed_lowstake",        # level gate: low-stake txn shed (L2+)
    "shed_backlog",         # backlog at capacity: refusal or preemption
)

#: stake classes, in ascending priority
CLASS_UNSTAKED, CLASS_LOW, CLASS_HI = 0, 1, 2
CLASS_NAMES = ("unstaked", "lowstake", "staked")

#: shared-memory `shed` region (ctx.shared("shed", SHED_FOOTPRINT)),
#: the SLO-engine -> quic-tile backchannel.  u64 words, two writers on
#: disjoint words (single-writer-per-word discipline):
#:   w0  commanded minimum shed level   (writer: flight recorder / SLO)
#:   w1  max SLO fast-burn x1000, info  (writer: flight recorder / SLO)
#:   w2  live shed level                (writer: quic tile)
#:   w3  cumulative level transitions   (writer: quic tile)
SHED_FOOTPRINT = 64
SHED_W_COMMANDED, SHED_W_BURN, SHED_W_LEVEL, SHED_W_TRANSITIONS = 0, 1, 2, 3


def sorted_stake_weights(stakes: dict[bytes, int]) -> list[tuple[bytes, int]]:
    """(pubkey -> stake) -> list ordered stake-desc, pubkey-desc — the
    deterministic order the schedule is sampled against."""
    return sorted(stakes.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)


def addr_identity(addr) -> bytes:
    """Canonical identity bytes for a socket address (the stake/QoS key
    for sources with no TLS identity — legacy UDP, pre-handshake QUIC)."""
    if isinstance(addr, tuple) and len(addr) >= 2:
        return f"{addr[0]}:{addr[1]}".encode()
    return repr(addr).encode()


def source_key(addr) -> str:
    """Per-source grouping key for connection caps: the IP, so one host
    opening thousands of connections from ephemeral ports is ONE source."""
    if isinstance(addr, tuple) and len(addr) >= 1:
        return str(addr[0])
    return repr(addr)


class TokenBucket:
    """Integer token bucket in the tick domain.

    Level is stored in tick-scaled micro-tokens (1 token == TICKS_PER_S
    units) so refill math is exact integer arithmetic: level grows by
    rate_per_s units per tick elapsed, capped at burst tokens.
    rate_per_s == 0 disables the bucket (always admits)."""

    __slots__ = ("rate", "cap", "level", "last")

    def __init__(self, rate_per_s: int, burst: int):
        self.rate = int(rate_per_s)
        self.cap = int(burst) * TICKS_PER_S
        self.level = self.cap
        self.last = 0

    def take(self, now: int, n: int = 1) -> int:
        """Admit up to n; returns how many were admitted (0..n)."""
        if self.rate <= 0:
            return n
        if now > self.last:
            self.level = min(
                self.level + (now - self.last) * self.rate, self.cap
            )
            self.last = now
        got = min(n, self.level // TICKS_PER_S)
        self.level -= got * TICKS_PER_S
        return int(got)


@dataclass(frozen=True)
class AdmissionConfig:
    """The `[tiles.quic]` admission knobs (app/config.py).  Defaults
    are permissive — EVERY limit defaults to 0/off except the global
    connection cap (which predates this layer: QuicServer.MAX_CONNS) —
    so an un-configured tile behaves exactly like the pre-admission
    build."""

    max_conns: int = 4096
    #: per-source-IP connection cap (0 = off)
    max_conns_per_source: int = 0
    #: handshake admissions per second across all sources (0 = off); a
    #: rate-limited Initial draws a stateless Retry (backoff signaling)
    handshake_rate: int = 0
    handshake_burst: int = 32
    #: per-connection txn rate (0 = off).  High-stake sources are exempt
    #: — their priority is the point of the stake table
    txn_rate: int = 0
    txn_burst: int = 64
    #: idle-churn eviction (0 = off)
    idle_timeout_s: float = 0.0
    #: a connection that has not completed its handshake within this
    #: window is evicted regardless of activity (slow-loris defense;
    #: 0 = off)
    handshake_timeout_s: float = 0.0
    #: txn backlog capacity across all stake classes (quic tile)
    backlog_cap: int = 8192
    #: shed controller: escalate when backlog occupancy >= shed_hi,
    #: de-escalate after occupancy <= shed_lo for shed_cooldown_s
    shed_hi: float = 0.75
    shed_lo: float = 0.25
    shed_cooldown_s: float = 1.0
    #: minimum time between UPWARD level transitions: hot occupancy
    #: walks the ladder one level per dwell, so a sub-dwell transient
    #: (GC pause, device hiccup) costs at most one level instead of
    #: jumping straight to emergency staked-only
    shed_dwell_s: float = 0.1
    #: stake weight below which a staked source classes as low-stake
    low_stake: int = 1000

    def to_dict(self) -> dict:
        from dataclasses import asdict

        return asdict(self)

    def autosized(self, n_active: int, base_active: int) -> "AdmissionConfig":
        """Scale the CAPACITY-shaped knobs with the live verify shard
        count (elastic topology, disco/elastic.py): the configured
        values are calibrated for `base_active` shards, so with
        n_active live shards the connection cap and txn backlog scale
        linearly — admission tracks what the pipeline can actually
        absorb.  RATE knobs (handshake/txn buckets) and the shed/
        eviction policy are per-source defenses, not capacity, and stay
        fixed."""
        import dataclasses

        n = max(int(n_active), 1)
        b = max(int(base_active), 1)
        if n == b:
            return self
        return dataclasses.replace(
            self,
            max_conns=max(self.max_conns * n // b, 1),
            backlog_cap=max(self.backlog_cap * n // b, 1),
        )

    @classmethod
    def from_dict(cls, doc: dict) -> "AdmissionConfig":
        import dataclasses

        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


class StakeTable:
    """Source identity -> stake weight; the QoS input at quic->verify.

    Identities are arbitrary bytes: a TLS peer identity (ed25519 pubkey
    learned from the QUIC handshake cert) when the source completed a
    handshake, else addr_identity(addr).  Weights follow the leader-
    schedule convention (flamenco/leaders.py sorted_stake_weights):
    plain non-negative integers, zero/absent == unstaked."""

    def __init__(
        self, stakes: dict[bytes, int] | None = None, low_stake: int = 1000
    ):
        self.stakes: dict[bytes, int] = dict(stakes or {})
        self.low_stake = int(low_stake)

    def weight(self, identity: bytes | None) -> int:
        if not identity:
            return 0
        return self.stakes.get(bytes(identity), 0)

    def cls_of(self, identity: bytes | None) -> int:
        w = self.weight(identity)
        if w <= 0:
            return CLASS_UNSTAKED
        return CLASS_LOW if w < self.low_stake else CLASS_HI

    def total(self) -> int:
        return sum(self.stakes.values())

    @classmethod
    def from_config(cls, doc: dict, low_stake: int = 1000) -> "StakeTable":
        """Parse a `[stakes]` config section: keys prefixed "0x" decode
        as hex identity bytes (TLS pubkeys); anything else is a literal
        identity string (addr identities like "127.0.0.1:9000")."""
        stakes: dict[bytes, int] = {}
        for k, v in (doc or {}).items():
            ident = (
                bytes.fromhex(k[2:]) if k.startswith("0x") else k.encode()
            )
            stakes[ident] = int(v)
        return cls(stakes, low_stake=low_stake)

    @classmethod
    def synthetic(
        cls, n: int, seed: int = 0, total_stake: int = 1_000_000,
        low_stake: int = 1000,
    ) -> "StakeTable":
        """Deterministic synthetic stake distribution for harnesses and
        benches, built on the SAME machinery the leader schedule samples
        against: a ChaCha20Rng(MODE_MOD) draws per-validator weights and
        flamenco.leaders.sorted_stake_weights fixes the canonical order
        (so the heaviest identity of a given seed is stable)."""
        from ..ballet.chacha20 import MODE_MOD, ChaCha20Rng

        rng = ChaCha20Rng(
            int(seed).to_bytes(8, "little") + bytes(24), MODE_MOD
        )
        raw: dict[bytes, int] = {}
        for i in range(n):
            ident = bytes(
                (rng.roll(256)) & 0xFF for _ in range(8)
            ) + i.to_bytes(4, "little")
            # heavy-tailed weights: a few whales, a long tail, like a
            # real validator set
            w = 1 + rng.roll(total_stake // max(n, 1))
            if rng.roll(8) == 0:
                w *= 16
            raw[ident] = int(w)
        return cls(dict(sorted_stake_weights(raw)), low_stake=low_stake)


@dataclass
class _ConnState:
    """Per-connection admission bookkeeping (keyed by conn key)."""

    source: str
    birth: int


class ConnAdmission:
    """Connection-level admission state machine.

    The wire edge calls, in order: admit_handshake() on every
    connection-opening Initial (cheap, before ANY allocation),
    admit_conn() immediately before a Connection object is created
    (registers the source), admit_txns() per drained txn burst, and
    conn_released() when a connection is reaped.  sweep() yields
    idle / handshake-deadline eviction victims for the housekeeping
    path.  All `now` arguments are tickcount ticks."""

    def __init__(
        self, cfg: AdmissionConfig, stakes: StakeTable | None = None
    ):
        self.cfg = cfg
        self.stakes = stakes or StakeTable(low_stake=cfg.low_stake)
        self.hs_bucket = TokenBucket(cfg.handshake_rate, cfg.handshake_burst)
        self.per_source: dict[str, int] = {}
        self.conns: dict[bytes, _ConnState] = {}
        #: per-flow txn buckets, keyed by conn scid / addr identity —
        #: SEPARATE from the conn registry so legacy-UDP flows never
        #: count against the QUIC connection caps.  Bounded: oldest
        #: entry evicted past 4x max_conns (a re-seen flow just gets a
        #: fresh full bucket — fail-open, bounded memory)
        self.txn_buckets: dict[bytes, TokenBucket] = {}
        # high-stake fast-path cache (avoids a cls_of lookup per call);
        # dict for insertion-order eviction — entries also die with
        # their connection in conn_released
        self._exempt: dict[bytes, None] = {}
        #: live shed level, mirrored in by the owner (LoadShedder.level)
        #: so L3 can refuse unstaked handshakes outright
        self.level = 0
        self._idle_ticks = int(cfg.idle_timeout_s * TICKS_PER_S)
        self._hs_ticks = int(cfg.handshake_timeout_s * TICKS_PER_S)

    # -- connection admission --------------------------------------------

    def admit_handshake(
        self, addr, now: int, validated: bool = False
    ) -> str | None:
        """Cheap pre-allocation gate for a connection-opening Initial;
        returns a REASONS code or None (admit).  validated=True marks a
        source that echoed a Retry token (it already paid the rate toll
        on its first Initial): exempt from the handshake bucket — the
        backoff signal must guarantee a legitimate client progress
        under exactly the flood that keeps the bucket empty — but
        never from the emergency level."""
        if (
            self.level >= 3
            and self.stakes.cls_of(addr_identity(addr)) == CLASS_UNSTAKED
        ):
            return "drop_emergency"
        if not validated and self.hs_bucket.take(now) < 1:
            return "drop_handshake_rate"
        return None

    def admit_conn(self, addr, now: int) -> str | None:
        """Cap check at the point a Connection would be allocated; on
        admit the source is registered (pair with conn_released).  The
        per-source check runs FIRST: a source-capped Initial is a hard
        refusal, while drop_conn_cap is retryable by the caller after
        it evicts at the table cap (churn absorption) — a refused
        Initial must never cost an existing peer its slot."""
        src = source_key(addr)
        if (
            self.cfg.max_conns_per_source > 0
            and self.per_source.get(src, 0)
            >= self.cfg.max_conns_per_source
        ):
            return "drop_source_cap"
        if len(self.conns) >= self.cfg.max_conns:
            return "drop_conn_cap"
        return None

    def conn_opened(self, key: bytes, addr, now: int) -> None:
        src = source_key(addr)
        self.per_source[src] = self.per_source.get(src, 0) + 1
        self.conns[bytes(key)] = _ConnState(source=src, birth=now)

    def conn_released(self, key: bytes) -> None:
        k = bytes(key)
        self._exempt.pop(k, None)
        self.txn_buckets.pop(k, None)
        st = self.conns.pop(k, None)
        if st is None:
            return
        left = self.per_source.get(st.source, 0) - 1
        if left > 0:
            self.per_source[st.source] = left
        else:
            self.per_source.pop(st.source, None)

    # -- txn admission ----------------------------------------------------

    def admit_txns(
        self, key: bytes, identity: bytes | None, now: int, n: int
    ) -> int:
        """Per-flow txn rate gate; returns the admitted count.
        High-stake sources are exempt (priority is the point); unknown
        flows (legacy UDP sources) get a bucket on first sight."""
        if self.cfg.txn_rate <= 0 or n <= 0:
            return n
        k = bytes(key)
        if k in self._exempt:
            return n
        if self.stakes.cls_of(identity) == CLASS_HI:
            if len(self._exempt) >= 4 * self.cfg.max_conns:
                self._exempt.pop(next(iter(self._exempt)))
            self._exempt[k] = None
            return n
        b = self.txn_buckets.get(k)
        if b is None:
            if len(self.txn_buckets) >= 4 * self.cfg.max_conns:
                self.txn_buckets.pop(next(iter(self.txn_buckets)))
            b = self.txn_buckets[k] = TokenBucket(
                self.cfg.txn_rate, self.cfg.txn_burst
            )
        return b.take(now, n)

    # -- eviction sweep ---------------------------------------------------

    def sweep(self, server, now: int) -> tuple[list, list]:
        """(idle_victims, handshake_victims): addrs to evict.  Idle =
        no datagram for idle_timeout; handshake = never established
        within handshake_timeout regardless of activity (slow-loris —
        trickled bytes keep a conn "active" forever otherwise)."""
        idle, loris = [], []
        if not self._idle_ticks and not self._hs_ticks:
            return idle, loris  # both evictions configured off
        for addr, conn in server.by_addr.items():
            last = getattr(conn, "last_rx_tick", 0)
            st = self.conns.get(bytes(conn.scid))
            birth = st.birth if st is not None else 0
            if self._hs_ticks and not conn.established and birth and (
                now - birth >= self._hs_ticks
            ):
                loris.append(addr)
            elif self._idle_ticks and last and (
                now - last >= self._idle_ticks
            ):
                idle.append(addr)
        return idle, loris


class LoadShedder:
    """Explicit degradation levels with hysteresis.

    Escalation is prompt but paced: one level per shed_dwell_s while
    occupancy holds at/above shed_hi, so a flood walks up the ladder
    across dwells — a sub-dwell transient costs at most one level, not
    a jump to emergency; de-escalation requires occupancy <= shed_lo
    sustained for shed_cooldown_s.  `commanded` (the SLO engine's recommendation
    from the shared shed region) is a FLOOR: local backpressure can
    raise the level above it but never below."""

    #: monitor / incident labels, index == level
    LEVEL_NAMES = (
        "admit-all", "shed-unstaked", "shed-lowstake", "staked-only"
    )
    MAX_LEVEL = 3

    def __init__(self, cfg: AdmissionConfig):
        self.cfg = cfg
        self.level = 0
        self.transitions = 0
        self._cool_ticks = int(cfg.shed_cooldown_s * TICKS_PER_S)
        self._dwell_ticks = int(cfg.shed_dwell_s * TICKS_PER_S)
        self._calm_since = 0  # tick when occupancy last fell calm; 0 = not
        self._hot_since = -1  # tick of the last upward transition; -1 = none

    @staticmethod
    def admits(cls_: int, level: int) -> bool:
        """Does a txn of stake class cls_ pass the level gate?"""
        if level <= 0:
            return True
        if level == 1:
            return cls_ >= CLASS_LOW
        return cls_ >= CLASS_HI  # L2 and L3: high-stake only

    def update(self, now: int, backlog_frac: float, commanded: int = 0) -> int:
        """One controller step; returns the (possibly new) level."""
        lvl = self.level
        if backlog_frac >= self.cfg.shed_hi:
            if (
                self._hot_since < 0
                or now - self._hot_since >= self._dwell_ticks
            ):
                lvl = min(lvl + 1, self.MAX_LEVEL)
                self._hot_since = now
            self._calm_since = 0
        elif backlog_frac <= self.cfg.shed_lo:
            if self._calm_since == 0:
                self._calm_since = now
            elif now - self._calm_since >= self._cool_ticks:
                lvl = max(lvl - 1, 0)
                self._calm_since = now
        else:
            self._calm_since = 0
        lvl = max(lvl, min(int(commanded), self.MAX_LEVEL))
        if lvl != self.level:
            self.level = lvl
            self.transitions += 1
        return self.level
