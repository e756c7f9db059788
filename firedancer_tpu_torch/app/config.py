"""TOML config -> ingress topology.

A copy of firedancer_tpu/app/config.py.  `[topo] runtime = "process"`
runs one OS process per tile (disco/topo.py; the metric and RPC tiles
stay threads in the parent), and both builders pass it through, so
`fdtctl run` takes it from the TOML.  Refused rather than ignored:
`[slo]` (disco/slo.py) and `[elastic]` (disco/elastic.py) raise
NotImplementedError, since the port has neither module yet.  Both
builders take `device` (None: the CUDA card, raising "no CUDA device" on a
host without one; "cpu": the plain versions, for tests) and hand it to the
verify tile, pack's device select, the shredder and the store's
Reed-Solomon recovery; the TOML has no device key.

Reference model: src/app/fdctl/config.c:577-760 — a TOML file (defaults in
config/default.toml) parsed into a typed config, from which the topology
(workspaces, links, tiles, connections) is derived programmatically.
Python 3.11+ ships tomllib, so no vendored parser is needed.

Config shape (all keys optional; defaults below):

    name = "fdt"                     # workspace name (monitor attaches)
    [topo]
    runtime = "thread"               # or "process": one OS process per tile
    stem = "python"                  # "native" = GIL-released tile inner loop
    [tiles.quic]
    quic_port = 0                    # 0 = ephemeral
    udp_port = 0
    # ingress admission (waltz/admission.py AdmissionConfig; all
    # optional — omitted keys take the permissive defaults: every
    # limit off except the pre-existing global connection cap):
    max_conns = 4096                 # global live-connection cap
    max_conns_per_source = 0         # per-source-IP cap, 0 = off
    handshake_rate = 0               # handshakes/s, 0 = unlimited
    handshake_burst = 32
    txn_rate = 0                     # per-connection txns/s, 0 = off
    txn_burst = 64
    idle_timeout_s = 0.0             # idle-churn eviction, 0 = off
    handshake_timeout_s = 0.0        # slow-loris eviction, 0 = off
    backlog_cap = 8192               # txn backlog across stake classes
    shed_hi = 0.75                   # shed escalation occupancy
    shed_lo = 0.25                   # shed de-escalation occupancy
    shed_cooldown_s = 1.0
    shed_dwell_s = 0.1               # min time between level raises
    low_stake = 1000                 # weight under this = low-stake
    [stakes]                         # identity -> stake weight (QoS);
    "0xdeadbeef..." = 500000         # 0x-prefixed = hex TLS identity
    "127.0.0.1:9000" = 1000000       # else a literal addr identity
    [tiles.verify]
    count = 1                        # horizontal seq-sharded replicas
    max_lanes = 4096
    msg_width = 1232
    devices = 1                      # device pool: "auto" | N | [ordinals]
    stall_patience_s = 120.0         # per-device tunnel-stall patience
    [tiles.dedup]
    signature_cache_size = 4194302   # default.toml:760
    [tiles.bank]
    count = 2                        # bank shards
    native = true                    # fdt_bank shared-memory executor
    table_slots = 16384              # shared account-table slots (pow2)
    [tiles.pack]
    depth = 4096                     # pending-txn pool slots
    mb_inflight = 1                  # outstanding microblocks per bank
    microblock_ns = 2000000          # per-bank cadence (fd_pack.c:26)
    txn_limit = 31                   # txns per microblock
    slot_ns = 400000000              # block-budget rollover period
    device_select = false            # select on the pack_select kernel
    [links]
    depth = 1024
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # Python 3.10: tomllib landed in 3.11
    import tomli as tomllib
from dataclasses import dataclass, field

from ..disco.topo import Topology
from ..tiles import wire
from ..tiles.dedup import DedupTile
from ..tiles.quic import QuicIngressTile
from ..tiles.sink import SinkTile
from ..tiles.verify import VerifyTile


@dataclass
class Config:
    name: str = "fdt"
    #: tile runtime from `[topo] runtime`: "thread" | "process" | None
    #: (the thread runtime)
    runtime: str | None = None
    #: ingress admission policy (waltz/admission.py AdmissionConfig)
    #: from the `[tiles.quic]` admission keys; None = permissive
    #: defaults (bit-compatible with the pre-hardening build)
    quic_admission: object | None = None
    #: `[stakes]` section: source identity -> stake weight (the
    #: quic->verify QoS gate input); raw dict, StakeTable-parsed by the
    #: topology builders
    stakes: dict = field(default_factory=dict)
    #: data-plane inner loop from `[topo] stem = "python"|"native"`:
    #: "native" runs registered tile handlers (net/dedup/bank/pack/poh/
    #: shred) through the GIL-released fdt_stem burst loop; None = python
    stem: str | None = None
    quic_port: int = 0
    udp_port: int = 0
    verify_count: int = 1
    verify_max_lanes: int = 4096
    verify_msg_width: int = 1232
    #: device pool width per replica: 1 (single stream), int N, explicit
    #: ordinal list, or "auto" (every local accelerator, split disjointly
    #: across the verify replicas by disco.topo.device_assignments)
    verify_devices: object = 1
    verify_stall_patience_s: float = 120.0
    dedup_depth: int = 4_194_302
    link_depth: int = 1024
    bank_count: int = 2
    #: native shared-memory batch executor (tango/native/fdt_bank.c);
    #: false = the per-txn python fast path (A/B + escape hatch)
    bank_native: bool = True
    #: shared account-table slots (64 B each, power of two) — one table
    #: shared by every bank shard, sized for the hot payer working set
    bank_table_slots: int = 16384
    pack_device_select: bool = False
    pack_depth: int = 4096
    pack_mb_inflight: int = 1
    pack_microblock_ns: int = 2_000_000
    pack_txn_limit: int = 31
    #: block-budget rollover period (mainnet slot duration); the native
    #: after-credit hook reads the derived deadline word, so the knob
    #: applies identically to both loop modes
    pack_slot_ns: int = 400_000_000
    ticks_per_slot: int = 64
    shred_version: int = 1
    metrics_port: int = 0
    rpc_port: int = 0
    raw: dict = field(default_factory=dict)


#: sections and values whose modules the port does not have yet
_NOT_PORTED = {"slo": "asserted SLOs (disco/slo.py)",
               "elastic": "the elastic topology (disco/elastic.py)"}


def parse(text: str) -> Config:
    """TOML text -> Config.  `[slo]` and `[elastic]` raise
    NotImplementedError; an unknown `[topo] runtime` is refused by the
    builders' Topology."""
    doc = tomllib.loads(text)
    for key, what in _NOT_PORTED.items():
        if key in doc:
            raise NotImplementedError(
                f"config section [{key}]: {what} is not ported yet"
            )
    t = doc.get("tiles", {})
    q = t.get("quic", {})
    v = t.get("verify", {})
    d = t.get("dedup", {})
    import dataclasses as _dc

    from ..waltz.admission import AdmissionConfig

    admission_keys = {
        f.name for f in _dc.fields(AdmissionConfig)
    } & set(q)
    return Config(
        name=doc.get("name", "fdt"),
        runtime=doc.get("topo", {}).get("runtime"),
        stem=doc.get("topo", {}).get("stem"),
        quic_admission=(
            AdmissionConfig.from_dict(q) if admission_keys else None
        ),
        stakes=dict(doc.get("stakes", {})),
        quic_port=q.get("quic_port", 0),
        udp_port=q.get("udp_port", 0),
        verify_count=v.get("count", 1),
        verify_max_lanes=v.get("max_lanes", 4096),
        verify_msg_width=v.get("msg_width", 1232),
        verify_devices=v.get("devices", 1),
        verify_stall_patience_s=v.get("stall_patience_s", 120.0),
        dedup_depth=d.get("signature_cache_size", 4_194_302),
        link_depth=doc.get("links", {}).get("depth", 1024),
        bank_count=t.get("bank", {}).get("count", 2),
        bank_native=t.get("bank", {}).get("native", True),
        bank_table_slots=t.get("bank", {}).get("table_slots", 16384),
        pack_device_select=t.get("pack", {}).get("device_select", False),
        pack_depth=t.get("pack", {}).get("depth", 4096),
        pack_mb_inflight=t.get("pack", {}).get("mb_inflight", 1),
        pack_microblock_ns=t.get("pack", {}).get(
            "microblock_ns", 2_000_000
        ),
        # reference parity default is 31 txns (MAX_TXN_PER_MICROBLOCK);
        # on shared-core hosts the effective microblock period is loop-
        # scheduling bound (~10x the reference's 2 ms), so proportionally
        # larger microblocks preserve the reference's duty cycle
        pack_txn_limit=t.get("pack", {}).get("txn_limit", 31),
        pack_slot_ns=t.get("pack", {}).get("slot_ns", 400_000_000),
        ticks_per_slot=t.get("poh", {}).get("ticks_per_slot", 64),
        shred_version=t.get("shred", {}).get("version", 1),
        metrics_port=t.get("metric", {}).get("port", 0),
        rpc_port=t.get("rpc", {}).get("port", 0),
        raw=doc,
    )


def _verify_device_split(cfg: Config, n: int, n_prov: int) -> list[list[int]]:
    """Device partition for n boot-ACTIVE verify replicas out of n_prov
    provisioned members: the active ones keep the full disjoint split,
    while spares get the whole ordinal list.  The port provisions no
    spares (it has no elastic topology), so n_prov == n at every caller;
    the split keeps the JAX package's contract all the same."""
    from ..disco.topo import device_assignments

    devs = device_assignments(cfg.verify_devices, n)
    if n_prov > n:
        spare = device_assignments(cfg.verify_devices, 1)[0]
        devs = devs + [list(spare) for _ in range(n_prov - n)]
    return devs


def _quic_policy(cfg: Config):
    """(AdmissionConfig, StakeTable) for the ingress tile from the
    parsed config — one place so both topology shapes agree."""
    from ..waltz.admission import AdmissionConfig, StakeTable

    adm = cfg.quic_admission or AdmissionConfig()
    return adm, StakeTable.from_config(cfg.stakes, low_stake=adm.low_stake)


def build_validator_topology(cfg: Config, identity_secret: bytes,
                             blockstore_path: str, funk=None, *, device=None):
    """The FULL single-host validator shape (reference wiring,
    config.c:624-760 + tile registry main.c:20-47):

        net -> quic -> verify xN -> dedup -> pack -> bank xB -> poh
            -> shred (keyguard sign rings) -> store
        + metric (Prometheus) + rpc (observer surface)

    funk: the account store the banks execute against (None: fee-only
    banks, and RPC getBalance answers an error).  device: where the verify
    tiles, pack's device select, the shredder and the store's recovery
    run (None: the CUDA card; raises "no CUDA device" before anything is
    declared on a host without one).  Returns (topo, handles dict)."""
    from ..ballet import shred as SH
    from ..ops.ed25519 import golden
    from ..tiles.bank import BankTile
    from ..tiles.metric import MetricTile
    from ..tiles.net import NET_MTU, NetTile
    from ..tiles.pack import PackTile
    from ..tiles.poh import ENTRY_SZ, PohTile
    from ..tiles.rpc import RpcTile
    from ..tiles.shred import ShredTile
    from ..tiles.sign import ROLE_SHRED, SignTile
    from ..tiles.store import StoreTile
    from ..utils import devices

    dev = devices.resolve(device)
    mb_mtu = 65_535
    depth = cfg.link_depth
    n = cfg.verify_count
    n_banks = cfg.bank_count
    verify_devs = _verify_device_split(cfg, n, n)
    topo = Topology(name=cfg.name, runtime=cfg.runtime, stem=cfg.stem)

    net = NetTile(
        quic_addr=("0.0.0.0", cfg.quic_port),
        udp_addr=("0.0.0.0", cfg.udp_port),
    )
    adm, stakes = _quic_policy(cfg)
    qt = QuicIngressTile(
        identity_secret, via_net=True, admission=adm, stakes=stakes
    )
    topo.link("net_quic", depth=depth, mtu=NET_MTU)
    topo.link("quic_net", depth=depth, mtu=NET_MTU)
    topo.link("quic_verify", depth=depth, mtu=wire.LINK_MTU)
    topo.tile(net, ins=[("quic_net", True)], outs=["net_quic"])
    topo.tile(qt, ins=[("net_quic", True)], outs=["quic_verify", "quic_net"])
    for i in range(n):
        topo.link(f"verify{i}_dedup", depth=depth, mtu=wire.LINK_MTU)
        topo.tile(
            VerifyTile(
                msg_width=cfg.verify_msg_width,
                max_lanes=cfg.verify_max_lanes,
                shard=((i, n) if n > 1 else None),
                # one shape: every sub-batch pads to max_lanes, so the
                # boot-time warm-up covers steady state AND trickle
                pad_full=True,
                device=dev,
                devices=verify_devs[i],
                stall_patience_s=cfg.verify_stall_patience_s,
                name=f"verify{i}",
            ),
            ins=[("quic_verify", True)],
            outs=[f"verify{i}_dedup"],
        )
    topo.link("dedup_pack", depth=depth, mtu=wire.LINK_MTU)
    topo.tile(
        DedupTile(depth=cfg.dedup_depth),
        ins=[(f"verify{i}_dedup", True) for i in range(n)],
        outs=["dedup_pack"],
    )
    # bank-facing ring depths must cover the pipelining depth (inflight
    # microblocks per bank) with headroom for completion batching
    bank_ring = 1 << max(64, 4 * cfg.pack_mb_inflight).bit_length()
    for i in range(n_banks):
        topo.link(f"pack_bank{i}", depth=bank_ring, mtu=mb_mtu)
        topo.link(f"bank{i}_pack", depth=bank_ring)
        topo.link(f"bank{i}_poh", depth=bank_ring, mtu=mb_mtu)
    topo.tile(
        PackTile(
            n_banks,
            use_device_select=cfg.pack_device_select,
            depth=cfg.pack_depth,
            mb_inflight=cfg.pack_mb_inflight,
            microblock_ns=cfg.pack_microblock_ns,
            txn_limit=cfg.pack_txn_limit,
            slot_ns=cfg.pack_slot_ns,
            device=dev,
        ),
        ins=[("dedup_pack", True)]
        + [(f"bank{i}_pack", True) for i in range(n_banks)],
        outs=[f"pack_bank{i}" for i in range(n_banks)],
    )
    for i in range(n_banks):
        topo.tile(
            BankTile(
                i, funk=funk, native=cfg.bank_native,
                table_slots=cfg.bank_table_slots,
            ),
            ins=[(f"pack_bank{i}", True)],
            outs=[f"bank{i}_pack", f"bank{i}_poh"],
        )
    topo.link("poh_shred", depth=4096, mtu=ENTRY_SZ)
    topo.tile(
        PohTile(ticks_per_slot=cfg.ticks_per_slot),
        ins=[(f"bank{i}_poh", True) for i in range(n_banks)],
        outs=["poh_shred"],
    )
    topo.link("shred_store", depth=4096, mtu=SH.MAX_SZ)
    topo.link("shred_sign", depth=256, mtu=32)
    topo.link("sign_shred", depth=256, mtu=64)
    topo.tile(
        ShredTile(shred_version=cfg.shred_version, device=dev),
        ins=[("poh_shred", True), ("sign_shred", True)],
        outs=["shred_store", "shred_sign"],
    )
    topo.tile(
        SignTile(identity_secret, roles=[ROLE_SHRED]),
        ins=[("shred_sign", True)],
        outs=["sign_shred"],
    )
    store = StoreTile(blockstore_path, device=dev)
    topo.tile(store, ins=[("shred_store", True)])
    metric = MetricTile(
        registry=topo.metrics_registry, addr=("0.0.0.0", cfg.metrics_port)
    )
    topo.tile(metric)
    rpc = RpcTile(
        txn_count=lambda: sum(
            topo.metrics(f"bank{i}").counter("executed_txns")
            for i in range(n_banks)
        ),
        slot=lambda: topo.metrics("poh").counter("slots"),
        funk=funk,
        identity=golden.public_from_secret(identity_secret),
        addr=("0.0.0.0", cfg.rpc_port),
    )
    topo.tile(rpc)
    return topo, {
        "net": net, "quic": qt, "store": store, "metric": metric, "rpc": rpc,
    }


def build_ingress_topology(
    cfg: Config, identity_secret: bytes, *, device=None
) -> tuple[Topology, QuicIngressTile]:
    """The production ingress shape: quic -> N seq-sharded verify ->
    dedup -> sink (reference connection map, config.c:681-712).  device
    as in build_validator_topology (the verify tiles' device)."""
    from ..utils import devices

    dev = devices.resolve(device)
    topo = Topology(name=cfg.name, runtime=cfg.runtime, stem=cfg.stem)
    adm, stakes = _quic_policy(cfg)
    qt = QuicIngressTile(
        identity_secret,
        quic_addr=("0.0.0.0", cfg.quic_port),
        udp_addr=("0.0.0.0", cfg.udp_port),
        admission=adm,
        stakes=stakes,
    )
    depth = cfg.link_depth
    topo.link("quic_verify", depth=depth, mtu=wire.LINK_MTU)
    topo.tile(qt, outs=["quic_verify"])
    n = cfg.verify_count
    verify_devs = _verify_device_split(cfg, n, n)
    for i in range(n):
        topo.link(f"verify{i}_dedup", depth=depth, mtu=wire.LINK_MTU)
        vt = VerifyTile(
            msg_width=cfg.verify_msg_width,
            max_lanes=cfg.verify_max_lanes,
            shard=((i, n) if n > 1 else None),
            device=dev,
            devices=verify_devs[i],
            stall_patience_s=cfg.verify_stall_patience_s,
            name=f"verify{i}",
        )
        topo.tile(
            vt, ins=[("quic_verify", True)], outs=[f"verify{i}_dedup"]
        )
    topo.link("dedup_sink", depth=depth, mtu=wire.LINK_MTU)
    dedup = DedupTile(depth=cfg.dedup_depth)
    topo.tile(
        dedup,
        ins=[(f"verify{i}_dedup", True) for i in range(n)],
        outs=["dedup_sink"],
    )
    topo.tile(SinkTile(), ins=[("dedup_sink", True)])
    return topo, qt
