"""QUIC + legacy-UDP ingress tile: the wire edge of the TPU pipeline.

A copy of firedancer_tpu/tiles/quic.py: both shapes (its own sockets, and
via_net=True behind the net tile), the batch ingest, the stake-class
backlogs, the shed controller (the commanded level is read from the shared
`shed` region, which nothing in the port writes yet, so it stays 0) and
the direct-socket egress burst (`_send_burst_native`).  Not ported yet,
and refused rather than ignored: the fault-injection pump (a ctx with
`faults` set raises NotImplementedError at boot and in after_credit) and
the elastic admission autosizing (`on_epoch` raises NotImplementedError).

Reference model: src/app/fdctl/run/tiles/fd_quic.c — a QUIC server whose
completed TPU streams are reassembled (src/disco/quic/fd_tpu.h) and
published as parsed txn + trailer frags to the verify tiles, plus the
legacy non-QUIC UDP path (fd_quic.c:148-170) where one datagram = one raw
txn.  This build listens on two UDP ports (QUIC and legacy) through the
waltz.udpsock burst interface; stream reassembly lives inside
waltz.quic.Connection and the txn parse/trailer format is shared with the
synth tile (tiles/wire.py), so downstream tiles cannot tell wire ingress
from synthetic ingress.

Hostile-ingress hardening: this tile is the front line
against the open internet, so every admission decision is explicit and
every rejection is a METERED DROP with a reason code — never an
exception out of the tile loop:

  * connection admission (waltz/admission.py ConnAdmission wired into
    the QuicServer): global + per-source caps, handshake-rate limiting
    with stateless-Retry backoff signaling, idle-churn and
    slow-loris (handshake-deadline) eviction;
  * a per-connection txn-rate token bucket at drain time;
  * a stake-weighted QoS gate at quic->verify: a StakeTable classes
    each source (TLS identity when the handshake completed, address
    identity otherwise) into unstaked / low-stake / high-stake; the
    txn backlog is one bounded priority queue PER CLASS, drained
    high-first, with preemption — at capacity an arriving staked txn
    evicts the oldest queued lower-class txn instead of being refused;
  * SLO-driven load shedding (LoadShedder): explicit degradation
    levels (admit-all -> shed-unstaked -> shed-lowstake ->
    emergency-staked-only) driven by live backlog occupancy AND the
    burn-rate engine's commanded level from the shared `shed` region
    (written by the JAX package's flight recorder); transitions are
    metered (`shed_level` gauge, `shed_transitions`).

The txn ledger closes by construction: gate_txns (txns presented to
the QoS gate) == admit_staked + admit_unstaked + drop_txn_rate +
shed_unstaked + shed_lowstake; the adversarial harness
(the JAX package's scripts/adversary.py) asserts it.  `shed_backlog` meters BOTH
refused enqueues and preemption victims — a preempted txn was already
admitted and counted toward rx_txns_* when first enqueued — so it is
a drop counter, not a term of the admit identity.

All admission/shed decisions run in the tango.tempo.tickcount clock
domain: no bare time.* reads on this hot path or in the Admission/Shed
classes.
"""

from __future__ import annotations

import collections
import os

import numpy as np

from ..ballet import pack as P
from ..ballet import txn as T
from ..disco.metrics import MetricsSchema
from ..disco.mux import MuxCtx, Tile
from ..tango import rings as R
from ..tango import tempo
from ..waltz import admission as ADM
from ..waltz import quic as Q
from ..waltz.admission import (
    AdmissionConfig,
    ConnAdmission,
    LoadShedder,
    StakeTable,
)
from ..waltz.udpsock import UdpSock
from . import wire
from .net import ADDR_SZ, CTL_LEGACY, NET_MTU, addr_pack, addr_unpack

#: stake classes drained high-priority-first by the publish path
_N_CLASSES = 3
#: gate-shed counter per class (CLASS_HI is never level-shed)
_SHED_COUNTER = ("shed_unstaked", "shed_lowstake", None)


class QuicIngressTile(Tile):
    """Terminates QUIC (and legacy UDP) and publishes txn+trailer frags."""

    name = "quic"
    schema = MetricsSchema(
        counters=(
            "rx_dgrams",
            "tx_dgrams",
            "rx_txns_quic",
            "rx_txns_udp",
            "parse_fail_txns",
            "conns_opened",
            # ---- hostile-ingress hardening ----
            # txn-level QoS gate ledger: gate_txns == admit_staked +
            # admit_unstaked + drop_txn_rate + shed_unstaked +
            # shed_lowstake (checked by scripts/adversary.py)
            "gate_txns",
            "admit_staked",
            "admit_unstaked",
            "drop_txn_rate",
            "shed_unstaked",
            "shed_lowstake",
            "shed_backlog",
            # connection admission refusals (waltz/admission.py REASONS)
            "drop_conn_cap",
            "drop_source_cap",
            "drop_handshake_rate",
            "drop_emergency",
            "retry_sent",
            # eviction sweeps: idle churn / never-completed handshakes
            "conns_evicted_idle",
            "conns_evicted_handshake",
            # load-shed controller state (gauge + cumulative edges)
            "shed_level",
            "shed_transitions",
            # hostile traffic synthesized by injected flood/conn_churn
            # faults (the JAX package's fault pump; 0 in the port)
            "adv_injected",
            # egress-burst tail dropped on EAGAIN (was a silent drop)
            "tx_eagain_drops",
            # elastic admission autosizing (the JAX package's
            # disco/elastic.py; 0 in the port)
            "adm_autosize",
            "adm_max_conns",
            "adm_backlog_cap",
            "elastic_verify_shards",
        ),
    )

    def __init__(
        self,
        identity_secret: bytes,
        *,
        quic_addr=("127.0.0.1", 0),
        udp_addr=("127.0.0.1", 0),
        burst: int = 256,
        via_net: bool = False,
        admission: AdmissionConfig | None = None,
        stakes: StakeTable | None = None,
        rand=os.urandom,
    ):
        """via_net=True: sans-IO mode behind a NetTile — ins[0] carries
        addr-prefixed datagram frags, outs[-1] is the tx ring back to the
        net tile (reference topology: net -> quic -> net).

        admission / stakes: the ingress-defense policy (plain dataclass /
        dict state, so the tile stays spawn-picklable for the process
        runtime).  None = permissive defaults, bit-compatible with the
        pre-hardening build at shed level 0.  `rand` (rand(n) -> bytes,
        default os.urandom) is the QuicServer's source of random bytes."""
        self.identity_secret = identity_secret
        self.rand = rand
        self._quic_addr_req = quic_addr
        self._udp_addr_req = udp_addr
        self.burst = burst
        self.via_net = via_net
        self.admission_cfg = admission or AdmissionConfig()
        self.stakes = stakes or StakeTable(
            low_stake=self.admission_cfg.low_stake
        )
        self.quic_sock: UdpSock | None = None
        self.udp_sock: UdpSock | None = None
        self.server: Q.QuicServer | None = None
        self.admission_ctl: ConnAdmission | None = None
        self.shedder: LoadShedder | None = None
        self._shed_words: np.ndarray | None = None

        # parsed txn+trailer payloads: one bounded deque per stake
        # class, drained high-class-first by the publish path (staked
        # traffic preempts unstaked when verify credits are scarce).
        # Deques + a preallocated publish buffer — the old list sliced
        # `self._backlog[credits:]` every burst, an O(backlog) copy per
        # iteration under backpressure
        self._backlogs: list[collections.deque] = [
            collections.deque() for _ in range(_N_CLASSES)
        ]
        self._backlog_total = 0
        self._tx_backlog: collections.deque = collections.deque()
        self._pub_rows: np.ndarray | None = None
        self._tx_rows: np.ndarray | None = None
        self._tx_szs: np.ndarray | None = None

    @property
    def _backlog(self) -> collections.deque:
        """Compat view: the unstaked-class queue (everything, when no
        stake table is configured).  NOTE: direct appends bypass the
        `_backlog_total` accounting the shed controller reads — tests
        only; production paths go through `_enqueue`."""
        return self._backlogs[ADM.CLASS_UNSTAKED]

    # bound addresses, available after on_boot (ports may be ephemeral)
    @property
    def quic_addr(self):
        return self.quic_sock.addr

    @property
    def udp_addr(self):
        return self.udp_sock.addr

    def shared_wksp_footprints(self) -> dict[str, int]:
        # the SLO-engine -> shed-controller backchannel: the flight
        # recorder writes the commanded minimum level, this tile writes
        # the live level (disjoint words; waltz/admission.py layout)
        return {"shed": ADM.SHED_FOOTPRINT}

    def on_boot(self, ctx: MuxCtx) -> None:
        if getattr(ctx, "faults", None) is not None:
            self._pump_injected(ctx, 0)
        if not self.via_net and self.quic_sock is None:
            # restart-safe: a supervised re-incarnation keeps the bound
            # sockets (senders hold the addresses) — only a first boot
            # opens them
            self.quic_sock = UdpSock(self._quic_addr_req)
            self.udp_sock = UdpSock(self._udp_addr_req)
        if self.admission_ctl is None:
            self.admission_ctl = ConnAdmission(
                self.admission_cfg, self.stakes
            )
            self.shedder = LoadShedder(self.admission_cfg)
        if self.server is None:
            self.server = Q.QuicServer(
                self.identity_secret,
                max_conns=self.admission_cfg.max_conns,
                admission=self.admission_ctl,
                rand=self.rand,
            )
        if ctx is not None and self._shed_words is None:
            mem = ctx.shared("shed", ADM.SHED_FOOTPRINT)
            self._shed_words = mem[: (len(mem) // 8) * 8].view(np.uint64)

    def on_epoch(self, ctx: MuxCtx) -> None:
        """The JAX tile autosizes its admission caps to the live verify
        shard count here (disco/elastic.py); the port has no elastic
        topology, and refuses rather than ignores the call."""
        raise NotImplementedError(
            "the QUIC tile's elastic admission autosizing (on_epoch) is "
            "not ported yet"
        )

    def on_halt(self, ctx: MuxCtx) -> None:
        if self.quic_sock:
            self.quic_sock.close()
        if self.udp_sock:
            self.udp_sock.close()

    #: preallocated egress row capacity (chunked above this)
    _TX_ROWS = 512

    def _tx(self, ctx: MuxCtx, out_pkts: list[tuple[bytes, tuple]]) -> None:
        """Send datagrams: straight out the socket via ONE sendmmsg
        burst (fdt_udp_send_burst), or queue them for the tx
        ring toward the net tile (one rx datagram can produce several
        tx datagrams, so ring publishes are credit-gated in _flush_tx)."""
        if not out_pkts:
            return
        if not self.via_net:
            sent = self._send_burst_native(out_pkts)
            ctx.metrics.inc("tx_dgrams", sent)
            if sent < len(out_pkts):
                # EAGAIN dropped the burst tail — a declared, metered
                # drop, not a silent one (the tail is unrecoverable
                # either way: QUIC loss recovery retransmits what
                # mattered)
                ctx.metrics.inc("tx_eagain_drops", len(out_pkts) - sent)
            return
        self._tx_backlog.extend(out_pkts)
        self._flush_tx(ctx)

    def _send_burst_native(self, pkts) -> int:
        """One batched-datagram syscall per burst instead of a Python
        sendto per packet; oversize payloads (never produced by our
        QUIC encoder) fall back to the per-packet path.  Returns the
        count actually sent; the caller meters any EAGAIN tail."""
        if self._tx_rows is None:
            self._tx_rows = np.zeros((self._TX_ROWS, NET_MTU), np.uint8)
            self._tx_szs = np.zeros(self._TX_ROWS, np.uint32)
        if any(len(d) + 6 > NET_MTU for d, _ in pkts):
            return self.quic_sock.send_burst(pkts)
        sent = 0
        for lo in range(0, len(pkts), self._TX_ROWS):
            chunk = pkts[lo : lo + self._TX_ROWS]
            for i, (d, addr) in enumerate(chunk):
                pre = addr_pack(addr)
                self._tx_rows[i, :6] = np.frombuffer(pre, np.uint8)
                self._tx_rows[i, 6 : 6 + len(d)] = np.frombuffer(
                    d, np.uint8
                )
                self._tx_szs[i] = 6 + len(d)
            got = R._lib.fdt_udp_send_burst(
                self.quic_sock.sock.fileno(),
                self._tx_rows.ctypes.data, self._tx_rows.shape[1],
                self._tx_szs.ctypes.data, len(chunk), None,
            )
            sent += max(int(got), 0)
            if got < len(chunk):
                break  # EAGAIN: the caller meters the dropped tail
        return sent

    def _flush_tx(self, ctx: MuxCtx) -> None:
        """Publish queued tx datagrams within the net ring's own credit
        headroom (independent of the txn ring's budget)."""
        if not self._tx_backlog:
            return

        out = ctx.outs[-1]
        n = min(len(self._tx_backlog), out.cr_avail(), self._TX_ROWS)
        if n <= 0:
            return
        if self._tx_rows is None:
            self._tx_rows = np.zeros((self._TX_ROWS, NET_MTU), np.uint8)
            self._tx_szs = np.zeros(self._TX_ROWS, np.uint32)
        rows = self._tx_rows
        szs = np.zeros(n, np.uint16)
        for i in range(n):
            d, addr = self._tx_backlog.popleft()
            payload = addr_pack(addr) + d
            rows[i, : len(payload)] = np.frombuffer(payload, np.uint8)
            szs[i] = len(payload)
        out.publish(np.arange(n, dtype=np.uint64), rows[:n], szs)
        ctx.metrics.inc("tx_dgrams", n)

    def during_housekeeping(self, ctx: MuxCtx) -> None:
        now = tempo.tickcount()
        # idle-churn + slow-loris eviction sweep: connections silent
        # past idle_timeout, or still handshaking past the handshake
        # deadline (trickled garbage keeps a loris conn "active", so
        # activity alone must not grant residency)
        if self.admission_ctl is not None and self.server is not None:
            idle, loris = self.admission_ctl.sweep(self.server, now)
            for addr in idle:
                if self.server.evict(addr):
                    ctx.metrics.inc("conns_evicted_idle")
            for addr in loris:
                if self.server.evict(addr):
                    ctx.metrics.inc("conns_evicted_handshake")
        # loss-recovery probe timers: retransmit when acks stall
        out_pkts = []
        for addr, conn in list(self.server.by_addr.items()):
            conn.on_timer()
            for d in conn.datagrams_out():
                out_pkts.append((d, addr))
        self._tx(ctx, out_pkts)

    # ---- stake-weighted txn gate ----------------------------------------

    def _conn_identity(self, conn, addr) -> bytes:
        """Stake identity: the TLS peer identity once the handshake
        completed (a staked validator proves its key), else the address
        identity (legacy UDP / pre-handshake sources are at best
        address-staked)."""
        pid = getattr(conn, "peer_identity", None) if conn else None
        return bytes(pid) if pid else ADM.addr_identity(addr)

    def _gate_raws(
        self, ctx: MuxCtx, raws: list[bytes], identity: bytes,
        key: bytes, now: int, admitted: list[list[bytes]],
    ) -> None:
        """Txn-level admission for one source's drained burst: rate
        bucket -> shed-level gate -> class queue.  Every outcome is a
        counter; the ledger gate_txns == admit_* + drop_txn_rate +
        shed_{unstaked,lowstake} closes per call."""
        if not raws:
            return
        m = ctx.metrics
        m.inc("gate_txns", len(raws))
        ok = self.admission_ctl.admit_txns(key, identity, now, len(raws))
        if ok < len(raws):
            m.inc("drop_txn_rate", len(raws) - ok)
            raws = raws[:ok]
        if not raws:
            return
        cls_ = self.stakes.cls_of(identity)
        if not LoadShedder.admits(cls_, self.shedder.level):
            m.inc(_SHED_COUNTER[cls_], len(raws))
            return
        m.inc("admit_staked" if cls_ else "admit_unstaked", len(raws))
        admitted[cls_].extend(raws)

    def _enqueue(self, ctx: MuxCtx, payload: bytes, cls_: int) -> bool:
        """Bounded-backlog append with stake preemption: at capacity an
        arriving higher-class txn evicts the OLDEST queued lower-class
        txn (metered shed_backlog) instead of being refused; same-or-
        higher-class incoming at capacity is the refused side."""
        qs = self._backlogs
        if self._backlog_total < self.admission_cfg.backlog_cap:
            qs[cls_].append(payload)
            self._backlog_total += 1
            return True
        for victim in range(cls_):
            if qs[victim]:
                qs[victim].popleft()
                ctx.metrics.inc("shed_backlog")
                qs[cls_].append(payload)
                return True
        ctx.metrics.inc("shed_backlog")
        return False

    def _shed_update(self, ctx: MuxCtx, now: int) -> None:
        """One load-shed controller step: live backlog occupancy, with
        the SLO engine's commanded level (shared `shed` region, written
        by the flight recorder) as a floor.  Level transitions are
        metered and mirrored to shared memory; the flight recorder
        freezes an incident bundle on every escalation edge."""
        frac = self._backlog_total / max(self.admission_cfg.backlog_cap, 1)
        commanded = 0
        if self._shed_words is not None:
            commanded = int(self._shed_words[ADM.SHED_W_COMMANDED])
        before = self.shedder.level
        level = self.shedder.update(now, frac, commanded)
        if level != before:
            ctx.metrics.set("shed_level", level)
            ctx.metrics.inc("shed_transitions")
            if self._shed_words is not None:
                self._shed_words[ADM.SHED_W_LEVEL] = np.uint64(level)
                self._shed_words[ADM.SHED_W_TRANSITIONS] = np.uint64(
                    self.shedder.transitions
                )
            self.admission_ctl.level = level

    def _drain_admit_drops(self, ctx: MuxCtx) -> None:
        """Mirror the server's refusal tally into the shared metrics."""
        drops = self.server.admit_drops
        if not drops:
            return
        for reason, n in drops.items():
            ctx.metrics.inc(reason, n)
        drops.clear()

    # ---- ingress ---------------------------------------------------------

    def on_frags(self, ctx: MuxCtx, in_idx: int, frags: np.ndarray) -> None:
        """via_net mode: datagram frags from the net tile."""
        now = tempo.tickcount()
        self.server.now_tick = now
        il = ctx.ins[in_idx]
        rows = il.gather(frags)
        out_pkts = []
        udp_by_src: dict = {}
        touched: list = []
        n_conns = len(self.server.conns)
        for i in range(len(rows)):
            row = rows[i, : frags["sz"][i]]
            addr = addr_unpack(row[:ADDR_SZ])
            data = row[ADDR_SZ:].tobytes()
            ctx.metrics.inc("rx_dgrams")
            if frags["ctl"][i] & CTL_LEGACY:
                udp_by_src.setdefault(addr, []).append(data)
                continue
            conn = self.server.on_datagram(data, addr)
            if conn is not None:
                for d in conn.datagrams_out():
                    out_pkts.append((d, addr))
                if conn.txns:
                    touched.append((conn, addr))
        self._ingest_sources(ctx, udp_by_src, touched, now)
        for pkt, addr in self.server.stateless_out:
            out_pkts.append((pkt, addr))
        self.server.stateless_out.clear()
        self._drain_admit_drops(ctx)
        if len(self.server.conns) > n_conns:
            ctx.metrics.inc("conns_opened", len(self.server.conns) - n_conns)
        self._tx(ctx, out_pkts)

    def _ingest_sources(
        self, ctx: MuxCtx, udp_by_src: dict, touched: list, now: int
    ) -> None:
        """Run every source's drained txns through the QoS gate, then
        parse each stake class as ONE batched scan (class-ordered within
        the burst; pipeline order across txns carries no semantics)."""
        if udp_by_src:
            admitted: list[list[bytes]] = [[] for _ in range(_N_CLASSES)]
            for addr, raws in udp_by_src.items():
                ident = ADM.addr_identity(addr)
                self._gate_raws(ctx, raws, ident, ident, now, admitted)
            for cls_ in range(_N_CLASSES - 1, -1, -1):
                self._ingest_batch(
                    ctx, admitted[cls_], "rx_txns_udp", cls_
                )
        if touched:
            admitted = [[] for _ in range(_N_CLASSES)]
            seen = set()
            for conn, addr in touched:
                if id(conn) in seen or not conn.txns:
                    continue
                seen.add(id(conn))
                raws, conn.txns = conn.txns, []
                self._gate_raws(
                    ctx, raws, self._conn_identity(conn, addr),
                    bytes(conn.scid), now, admitted,
                )
            for cls_ in range(_N_CLASSES - 1, -1, -1):
                self._ingest_batch(
                    ctx, admitted[cls_], "rx_txns_quic", cls_
                )

    def _ingest_batch(
        self, ctx: MuxCtx, raws: list[bytes], counter: str, cls_: int = 0
    ) -> None:
        """Parse + trailer a whole ingest batch in ONE native call
        (fdt_txn_scan's wire-trailer output) instead of a per-txn
        Python T.parse + append_trailer loop.

        Behavior is bit-identical to the per-txn path per batch: scan
        ok covers parse AND compute-budget estimate, but the old path
        only dropped parse failures — so rejects take a per-txn Python
        fallback that keeps estimate-fail txns flowing (pack drops them
        later under its own reject metric).  Rejects are rare on real
        traffic, so the fallback stays off the hot path."""
        if not raws:
            return
        n = len(raws)
        rows = np.zeros((n, wire.LINK_MTU), np.uint8)
        szs = np.zeros(n, np.uint32)
        for i, raw in enumerate(raws):
            if len(raw) <= T.MTU:
                rows[i, : len(raw)] = np.frombuffer(raw, np.uint8)
                szs[i] = len(raw)
            # oversize datagrams keep sz 0: the scan rejects them and
            # the fallback's T.parse delivers the old verdict
        scan = P.txn_scan(rows, szs, with_trailer=True)
        n_ok = 0
        n_fail = 0
        for i in range(n):
            if scan.ok[i]:
                if self._enqueue(ctx, bytes(rows[i, : scan.tszs[i]]), cls_):
                    n_ok += 1
                continue
            desc = T.parse(raws[i])
            if desc is None:
                n_fail += 1
            elif self._enqueue(
                ctx, wire.append_trailer(raws[i], desc), cls_
            ):
                n_ok += 1
        if n_ok:
            ctx.metrics.inc(counter, n_ok)
        if n_fail:
            ctx.metrics.inc("parse_fail_txns", n_fail)

    # ---- injected hostile traffic ---------------------------------------

    def _pump_injected(self, ctx: MuxCtx, now: int) -> None:
        """The JAX tile synthesizes the fault injector's hostile traffic
        here (disco/faultinj.py flood / conn_churn); the port has no fault
        injector, and refuses a ctx that carries one."""
        raise NotImplementedError(
            "the QUIC tile's fault-injection pump (ctx.faults) is not "
            "ported yet"
        )

    # ---- publish ---------------------------------------------------------

    def after_credit(self, ctx: MuxCtx) -> None:
        now = tempo.tickcount()
        n_conns = len(self.server.conns)
        self.server.now_tick = now
        self._shed_update(ctx, now)
        if getattr(ctx, "faults", None) is not None:
            self._pump_injected(ctx, now)
        if not self.via_net:
            # legacy UDP: one datagram = one txn (fd_quic.c legacy path);
            # gated per source, then ONE native parse+trailer call per
            # stake class
            udp_by_src: dict = {}
            for data, addr in self.udp_sock.recv_burst(self.burst):
                ctx.metrics.inc("rx_dgrams")
                udp_by_src.setdefault(addr, []).append(data)

            # QUIC datagrams
            out_pkts = []
            touched = []
            for data, addr in self.quic_sock.recv_burst(self.burst):
                ctx.metrics.inc("rx_dgrams")
                conn = self.server.on_datagram(data, addr)
                if conn is not None:
                    touched.append((conn, addr))
            for conn, addr in touched:
                for d in conn.datagrams_out():
                    out_pkts.append((d, addr))
            self._ingest_sources(ctx, udp_by_src, touched, now)
            # stateless Retry responses (server retry mode + the
            # handshake-rate backoff signal)
            for pkt, addr in self.server.stateless_out:
                out_pkts.append((pkt, addr))
            self.server.stateless_out.clear()
            self._tx(ctx, out_pkts)
        self._drain_admit_drops(ctx)
        if len(self.server.conns) > n_conns:
            ctx.metrics.inc("conns_opened", len(self.server.conns) - n_conns)

        if self.via_net:
            self._flush_tx(ctx)  # drain tx held back by net-ring credits
        # publish backlog within credit budget (txn ring = outs[0] only;
        # in via_net mode outs[-1] is the net tx ring).  The backlogs
        # are per-stake-class deques drained HIGH CLASS FIRST into a
        # preallocated row buffer — staked traffic preempts unstaked
        # when verify credits are scarce, and the old list slice
        # (`self._backlog[credits:]`) that copied the WHOLE remaining
        # backlog every iteration under backpressure is gone.
        if ctx.credits <= 0 or not any(self._backlogs):
            return
        if self._pub_rows is None:
            self._pub_rows = np.zeros(
                (self._TX_ROWS, wire.LINK_MTU), np.uint8
            )
        credits = ctx.credits
        for cls_ in range(_N_CLASSES - 1, -1, -1):
            q = self._backlogs[cls_]
            while q and credits > 0:
                # chunked through the preallocated buffer: the WHOLE
                # credit budget drains per firing, _TX_ROWS rows at a
                # time
                n = min(len(q), credits, self._TX_ROWS)
                rows = self._pub_rows
                szs = np.zeros(n, np.uint16)
                for i in range(n):
                    payload = q.popleft()
                    rows[i, : len(payload)] = np.frombuffer(
                        payload, np.uint8
                    )
                    szs[i] = len(payload)
                self._backlog_total = max(self._backlog_total - n, 0)
                tr = wire.parse_trailers(rows[:n], szs.astype(np.int64))
                sig0 = rows[
                    np.arange(n)[:, None],
                    tr["sig_off"][:, None] + np.arange(8),
                ]
                tags = sig0.astype(np.uint64) @ (
                    np.uint64(1)
                    << (np.uint64(8) * np.arange(8, dtype=np.uint64))
                )
                ctx.outs[0].publish(tags, rows[:n], szs)
                ctx.metrics.inc("out_frags", n)
                credits -= n
