"""Monitor: observe a running topology from OUTSIDE its process.

Reference model: src/app/fdctl/monitor/monitor.c:233 — periodically
snapshot every tile's cnc heartbeat/signal and metrics shared memory plus
every link's fseq, render the diffs.  This build attaches to the named
workspace via its published directory (tango.rings.Workspace.attach) and
reads the same single-writer regions the tiles write lock-free.

A copy of firedancer_tpu/app/monitor.py without its SLO, flight and
elastic branches: the port has no asserted SLOs, no flight recorder and
no elastic shards, so a manifest that carries one of those keys raises
NotImplementedError naming the module.  A topology built with
enable_profile() publishes its profiler regions, and the monitor renders
one `prof:` sub-row per tile (disco/profile.py profile_row).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..disco.metrics import (
    Metrics,
    MetricsSchema,
    device_rows,
    hist_delta as _hist_delta,
    hist_percentile,
)
from ..tango import rings as R

#: the per-in-link latency-attribution hist prefixes the run loop
#: records (disco.mux.LINK_HIST_KINDS) — the monitor renders these as
#: per-hop percentile rows
_LAT_PREFIXES = ("qwait_us_", "svc_us_", "e2e_us_")

_SIGNAMES = {0: "BOOT", 1: "RUN", 2: "HALT", 3: "FAIL"}

#: manifest keys of layers the port has not ported, with the module each
#: waits for
_NOT_PORTED = {"slo": "disco/slo.py", "flight": "disco/flight.py",
               "elastic": "disco/elastic.py"}


@dataclass
class TileView:
    name: str
    metrics: Metrics
    cnc: R.CNC


class Monitor:
    """Attach-and-read view of a named topology workspace."""

    # class-level defaults keep alarms()/render() working over a bare
    # snapshot dict even on a Monitor built without __init__ (tests
    # construct bare instances via object.__new__ to drive them
    # offline).  NOTE: alarms() is not pure — the stem-pin detector
    # keeps per-instance streak state across calls, so feed it a live
    # snapshot SEQUENCE, not replayed history.

    #: resolved stem mode from the manifest (python|native|None) — keys
    #: the stem-coverage rows; None on bare offline instances
    stem_mode: str | None = None
    #: stem-pin persistence state: last (stem_frags,
    #: py_frags) per tile and the consecutive-snapshot streak of
    #: "py_frags advanced while stem_frags sat flat".  Class-level None
    #: (lazily replaced per instance) for the same bare-instance reason
    #: as above.
    _stem_last: dict | None = None
    _stem_pin: dict | None = None
    #: consecutive pinned snapshots before the alarm fires — one
    #: handback window (dedup amnesty draining) is normal; persistent
    #: pinning is silent native-coverage loss
    STEM_PIN_STREAK = 3

    def __init__(self, wksp_name: str):
        self.wksp, extra = R.Workspace.attach(wksp_name)
        for key, module in _NOT_PORTED.items():
            if key in extra:
                self.wksp.close()
                raise NotImplementedError(
                    f"the manifest of {wksp_name!r} carries {key!r}: the "
                    f"port's monitor has no {module} yet"
                )
        self.tiles: dict[str, TileView] = {}
        for name, t in extra.get("tiles", {}).items():
            schema = MetricsSchema(
                counters=tuple(t["counters"]),
                hists=tuple(t["hists"]),
                # layout-affecting: wide hists store more buckets
                wide_hists=tuple(t.get("wide_hists", ())),
            )
            # schema comes pre-flattened (with_base applied by the topo)
            m = Metrics(self.wksp.view(t["metrics"]), schema)
            self.tiles[name] = TileView(
                name, m, R.CNC(self.wksp.view(t["cnc"]), join=True)
            )
        self.links = extra.get("links", {})
        self.stem_mode = extra.get("stem")
        # per-tile run-loop profiler regions (disco/profile.py), when
        # the topology was built with enable_profile()
        self.profiles: dict[str, Metrics] = {}
        prof = extra.get("profile")
        if prof is not None:
            from ..disco.profile import PROFILE_SCHEMA

            for name, alloc in prof.get("tiles", {}).items():
                self.profiles[name] = Metrics(
                    self.wksp.view(alloc), PROFILE_SCHEMA
                )

    #: heartbeat older than this is flagged as stale (reference monitor
    #: renders heartbeat diffs; a stuck tile stops beating long before
    #: the fail-stop supervisor sees it die)
    STALE_HEARTBEAT_NS = 2_000_000_000

    def snapshot(self) -> dict:
        """One consistent-enough read of every tile's state."""
        import time as _t

        now = _t.monotonic_ns()
        out = {}
        for name, tv in self.tiles.items():
            hb = tv.cnc.heartbeat_query()
            out[name] = {
                "signal": _SIGNAMES.get(
                    tv.cnc.signal_query(), str(tv.cnc.signal_query())
                ),
                "heartbeat": hb,
                "stale": bool(hb) and now - hb > self.STALE_HEARTBEAT_NS,
                "counters": {
                    c: tv.metrics.counter(c)
                    for c in tv.metrics.schema.counters
                },
                # per-hop latency attribution hists (queue-wait /
                # service / end-to-end per in-link)
                "lat_hists": {
                    h: tv.metrics.hist(h)
                    for h in tv.metrics.schema.hists
                    if h.startswith(_LAT_PREFIXES)
                },
            }
        for lname, ls in self.links.items():
            prod_seq = None
            if "mcache" in ls:
                mc = R.MCache(
                    self.wksp.view(ls["mcache"]), ls["depth"], join=True
                )
                prod_seq = mc.seq_query()
            seqs = {}
            for c in ls["consumers"]:
                fs = R.FSeq(self.wksp.view(c["fseq"]), join=True)
                cseq = fs.query()
                seqs[c["tile"]] = {
                    "seq": cseq,
                    # consumer lag behind the producer cursor, in frags
                    "lag": None
                    if prod_seq is None
                    else max(prod_seq - cseq, 0),
                }
            out.setdefault("_links", {})[lname] = {
                "produced": prod_seq,
                "consumers": seqs,
            }
        # profiler summaries ride the snapshot (disco/profile.py)
        if self.profiles:
            from ..disco.profile import profile_row

            for name, pm in self.profiles.items():
                if name in out:
                    out[name]["profile"] = profile_row(pm)
        return out

    @staticmethod
    def stem_row(counters: dict) -> dict | None:
        """The per-tile stem-coverage row: the native-vs-
        Python frag split of a stem-ENGAGED tile, None otherwise.
        `coverage` is cumulative stem_frags / (stem_frags + py_frags);
        `pinned` flags a tile whose stem NEVER consumed a frag while
        the Python loop handled a meaningful number — full native-
        coverage loss visible even from one snapshot (--once)."""
        if not counters.get("stem_engaged"):
            return None
        sf = int(counters.get("stem_frags", 0))
        pf = int(counters.get("py_frags", 0))
        tot = sf + pf
        return {
            "engaged": True,
            "stem_frags": sf,
            "py_frags": pf,
            "coverage": round(sf / tot, 4) if tot else None,
            "pinned": sf == 0 and pf >= Monitor.STEM_PIN_MIN_FRAGS,
        }

    #: cumulative py_frags below this never count as a full pin — a
    #: couple of boot-window handbacks are normal stem behavior
    STEM_PIN_MIN_FRAGS = 64

    def alarms(self, snap: dict) -> list[str]:
        """Stale heartbeats, failed tiles, and supervisor degradation
        state (circuit breaker open / restart churn), as alarm lines."""
        out = []
        for name, row in snap.items():
            if name.startswith("_"):
                continue
            c = row.get("counters", {})
            # stem-coverage pin detection: a stem-configured
            # tile persistently handling frags on the Python loop has
            # silently lost native coverage (dedup amnesty wedged, a
            # frag-fault pin, a handler that keeps bailing) — a loss
            # that is invisible from outside the process otherwise
            srow = self.stem_row(c)
            if srow is not None:
                if self._stem_pin is None:
                    self._stem_pin = {}
                    self._stem_last = {}
                sf, pf = srow["stem_frags"], srow["py_frags"]
                p_sf, p_pf = self._stem_last.get(name, (sf, pf))
                self._stem_last[name] = (sf, pf)
                if sf < p_sf or pf < p_pf:
                    # counters rewound (workspace rebuilt / replayed
                    # snapshots): two unrelated pin episodes must not
                    # combine into one alarm-triggering streak
                    self._stem_pin[name] = 0
                elif pf > p_pf and sf == p_sf:
                    self._stem_pin[name] = self._stem_pin.get(name, 0) + 1
                elif sf > p_sf:
                    self._stem_pin[name] = 0
                if (
                    srow["pinned"]
                    or self._stem_pin.get(name, 0) >= self.STEM_PIN_STREAK
                ):
                    out.append(
                        f"ALARM {name}: stem-configured tile pinned to "
                        f"the Python loop (stem_frags={sf:,} flat, "
                        f"py_frags={pf:,}) — native coverage lost "
                        f"(amnesty or fault pin?)"
                    )
            if c.get("degraded"):
                out.append(
                    f"ALARM {name}: degraded (supervisor circuit breaker "
                    f"open after {c.get('restarts', 0)} restarts)"
                )
                continue
            if row["signal"] == "FAIL":
                out.append(f"ALARM {name}: FAIL signal")
            elif row.get("stale"):
                out.append(f"ALARM {name}: heartbeat stale")
            if c.get("fallback_batches"):
                out.append(
                    f"NOTE {name}: {c['fallback_batches']} batches on the "
                    f"host fallback path"
                )
            # ingress load-shed state (hardened quic tiles): emergency
            # staked-only is an alarm; any active shedding is a note
            lvl = c.get("shed_level")
            if lvl:
                from ..waltz.admission import LoadShedder

                label = LoadShedder.LEVEL_NAMES[
                    min(int(lvl), LoadShedder.MAX_LEVEL)
                ]
                line = (
                    f"{name}: ingress shed level {lvl} ({label}) after "
                    f"{c.get('shed_transitions', 0)} transitions"
                )
                out.append(
                    f"ALARM {line}" if int(lvl) >= 3 else f"NOTE {line}"
                )
            if c.get("tx_eagain_drops"):
                out.append(
                    f"NOTE {name}: {c['tx_eagain_drops']} egress datagrams "
                    f"dropped on EAGAIN (socket send buffer pressure)"
                )
            # per-device fault domains (the verify pool): a quarantined /
            # stalled / dead device alarms as `verify0_dev3_degraded`
            # style lines — one device degrading is NOT tile degradation
            for i, row in sorted(device_rows(c).items()):
                if row.get("degraded"):
                    out.append(
                        f"ALARM {name}_dev{i}_degraded: device quarantined "
                        f"(landed {row.get('landed', 0)}, failed "
                        f"{row.get('failed', 0)})"
                    )
        return out

    def render(self, prev: dict | None, cur: dict, dt: float) -> str:
        """Tile table with in/out rates (frags/s), %backpressure, and
        per-hop latency percentiles since the last snapshot."""
        lines = [
            f"{'tile':>10} {'state':>5} {'in/s':>12} {'out/s':>12} "
            f"{'in_frags':>12} {'out_frags':>12} {'bp%':>6}"
        ]
        for name, row in cur.items():
            if name.startswith("_"):
                continue
            c = row["counters"]
            if prev is not None and name in prev:
                p = prev[name]["counters"]
                rin = (c["in_frags"] - p["in_frags"]) / dt
                rout = (c["out_frags"] - p["out_frags"]) / dt
                d_bp = c.get("backpressure_iters", 0) - p.get(
                    "backpressure_iters", 0
                )
                d_loop = c.get("loop_iters", 0) - p.get("loop_iters", 0)
            else:
                rin = rout = 0.0
                d_bp = c.get("backpressure_iters", 0)
                d_loop = c.get("loop_iters", 0)
            # %backpressure: share of loop iterations spent with zero
            # credits (stalled behind a slow reliable consumer) in the
            # window — every backpressure iteration also counts in
            # loop_iters, so the ratio is direct
            bp_pct = 100.0 * d_bp / max(d_loop, 1)
            flag = " STALE" if row.get("stale") else ""
            if c.get("degraded"):
                flag += " DEGRADED"
            elif c.get("restarts"):
                flag += f" restarts={c['restarts']}"
            lines.append(
                f"{name:>10} {row['signal']:>5} {rin:12,.0f} {rout:12,.0f} "
                f"{c['in_frags']:12,} {c['out_frags']:12,} {bp_pct:5.1f}%"
                f"{flag}"
            )
            # per-hop latency sub-rows: queue-wait / end-to-end
            # percentiles per in-link (the qwait/svc/e2e hists the run
            # loop records in the compressed-µs domain), windowed
            # against the previous snapshot like bp% — a regression
            # hours into a run must move the displayed p99 within one
            # refresh, not be pinned by cumulative history
            links = sorted(
                {
                    h[len("qwait_us_"):]
                    for h in row.get("lat_hists", {})
                    if h.startswith("qwait_us_")
                }
            )
            p_hists = (
                prev[name].get("lat_hists", {})
                if prev is not None and name in prev
                else {}
            )
            for ln in links:
                hq = _hist_delta(
                    row["lat_hists"].get(f"qwait_us_{ln}", {}),
                    p_hists.get(f"qwait_us_{ln}"),
                )
                he = _hist_delta(
                    row["lat_hists"].get(f"e2e_us_{ln}", {}),
                    p_hists.get(f"e2e_us_{ln}"),
                )
                if not hq.get("count") and not he.get("count"):
                    continue
                lines.append(
                    f"{'':>10}   lat {ln}: "
                    f"qwait p50={hist_percentile(hq, 50):,.0f}us "
                    f"p99={hist_percentile(hq, 99):,.0f}us | "
                    f"e2e p50={hist_percentile(he, 50):,.0f}us "
                    f"p99={hist_percentile(he, 99):,.0f}us"
                )
            # stem-coverage sub-row: the native-vs-Python
            # frag split for stem-engaged tiles, windowed vs the
            # previous snapshot so live coverage loss moves the row
            srow = self.stem_row(c)
            if srow is not None:
                if prev is not None and name in prev:
                    p = prev[name]["counters"]
                    d_sf = srow["stem_frags"] - p.get("stem_frags", 0)
                    d_pf = srow["py_frags"] - p.get("py_frags", 0)
                else:
                    d_sf, d_pf = srow["stem_frags"], srow["py_frags"]
                d_tot = d_sf + d_pf
                cov = srow["coverage"]
                lines.append(
                    f"{'':>10}   stem: cov="
                    + ("-" if cov is None else f"{cov * 100:.1f}%")
                    + (
                        ""
                        if not d_tot
                        else f" (win {100.0 * d_sf / d_tot:.1f}%)"
                    )
                    + f" stem_frags={srow['stem_frags']:,}"
                    f" py_frags={srow['py_frags']:,}"
                    + (" PINNED" if srow["pinned"] else "")
                )
            # run-loop profile sub-row (enable_profile topologies):
            # GIL-wait share, phase split, scheduler-lag p99
            prof = row.get("profile")
            if prof and prof.get("samples"):
                lines.append(
                    f"{'':>10}   prof: gil_wait "
                    f"{prof['gil_wait_frac'] * 100:.1f}% | frag "
                    f"{prof['frag_frac'] * 100:.0f}% hk "
                    f"{prof['hk_frac'] * 100:.0f}% credit "
                    f"{prof['credit_frac'] * 100:.0f}% bp "
                    f"{prof.get('bp_frac', 0) * 100:.0f}% | sched_lag "
                    f"p99={prof['sched_lag_p99_us']:,.0f}us"
                )
            # ingress-defense sub-row (hardened quic tiles): shed level
            # + the drop ledger by reason, so "where did the flood die"
            # is answerable from the monitor alone
            if "shed_level" in c and (
                c.get("gate_txns") or c.get("shed_level")
            ):
                drops = {
                    "conn": c.get("drop_conn_cap", 0)
                    + c.get("drop_source_cap", 0)
                    + c.get("drop_emergency", 0),
                    "hs": c.get("drop_handshake_rate", 0),
                    "rate": c.get("drop_txn_rate", 0),
                    "shed": c.get("shed_unstaked", 0)
                    + c.get("shed_lowstake", 0)
                    + c.get("shed_backlog", 0),
                    "evict": c.get("conns_evicted_idle", 0)
                    + c.get("conns_evicted_handshake", 0),
                }
                lines.append(
                    f"{'':>10}   ingress: level={c.get('shed_level', 0)} "
                    f"staked={c.get('admit_staked', 0):,} "
                    f"unstaked={c.get('admit_unstaked', 0):,} | drops "
                    + " ".join(f"{k}={v:,}" for k, v in drops.items())
                )
            # device-pool health sub-rows (tiles exporting dev{i}_*
            # counters — the multi-device verify scale-out)
            devs = device_rows(c)
            if len(devs) > 1 or any(
                r.get("degraded") for r in devs.values()
            ):
                for i, r in sorted(devs.items()):
                    dflag = " DEGRADED" if r.get("degraded") else ""
                    lines.append(
                        f"{'':>10}   dev{i}: depth={r.get('depth', 0)} "
                        f"inflight={r.get('inflight', 0)} "
                        f"landed={r.get('landed', 0):,} "
                        f"failed={r.get('failed', 0)}{dflag}"
                    )
        for lname, ls in cur.get("_links", {}).items():
            for tile, s in ls["consumers"].items():
                if s["lag"]:
                    lines.append(
                        f"{'':>10} link {lname} -> {tile}: lag {s['lag']:,}"
                    )
        lines.extend(self.alarms(cur))
        return "\n".join(lines)

    def run(self, interval_s: float = 1.0, iterations: int | None = None):
        """Print live rates until interrupted (fdctl monitor behavior)."""
        prev = None
        i = 0
        while iterations is None or i < iterations:
            cur = self.snapshot()
            print(self.render(prev, cur, interval_s))
            print()
            prev = cur
            i += 1
            if iterations is None or i < iterations:
                time.sleep(interval_s)

    def once(self) -> dict:
        """One machine-readable snapshot document: full tile rows,
        link state and alarms — the `--once --json` surface scripts
        scrape without a TTY.  Counters are cumulative (no rates: rates need a second
        refresh; consumers diff two documents)."""
        snap = self.snapshot()
        doc = {
            "tiles": {
                k: v
                for k, v in snap.items()
                if k != "_links"
            },
            "links": snap.get("_links", {}),
            "alarms": self.alarms(snap),
        }
        # per-tile stem-coverage doc: the native/Python frag
        # split machine-readable, so CI can assert coverage floors
        if self.stem_mode is not None:
            doc["stem_mode"] = self.stem_mode
        for k, v in doc["tiles"].items():
            srow = self.stem_row(v.get("counters", {}))
            if srow is not None:
                v["stem"] = srow
        return doc


def main(argv: list[str] | None = None) -> int:
    """CLI: `python -m firedancer_tpu_torch.app.monitor WKSP [--once]
    [--json] [-i SECONDS] [--iterations N]`."""
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="monitor", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("wksp", help="topology workspace name")
    ap.add_argument("--once", action="store_true",
                    help="single refresh, then exit (CI / scripting)")
    ap.add_argument("--json", action="store_true",
                    help="emit the snapshot as JSON (implies no TTY UI)")
    ap.add_argument("--interval", "-i", type=float, default=1.0)
    ap.add_argument("--iterations", type=int, default=None,
                    help="stop the live loop after N refreshes")
    args = ap.parse_args(argv)
    try:
        mon = Monitor(args.wksp)
    except FileNotFoundError:
        print(
            f"monitor: no workspace {args.wksp!r} (is the topology "
            "running with a name, and was start() reached?)",
            file=sys.stderr,
        )
        return 2
    if args.once:
        doc = mon.once()
        if args.json:
            print(json.dumps(doc, sort_keys=True, default=int))
        else:
            snap = {**doc["tiles"], "_links": doc["links"]}
            print(mon.render(None, snap, args.interval))
        return 0
    if args.json:
        # line-delimited JSON stream, one document per refresh
        i = 0
        while args.iterations is None or i < args.iterations:
            print(json.dumps(mon.once(), sort_keys=True, default=int),
                  flush=True)
            i += 1
            if args.iterations is None or i < args.iterations:
                time.sleep(args.interval)
        return 0
    mon.run(interval_s=args.interval, iterations=args.iterations)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
