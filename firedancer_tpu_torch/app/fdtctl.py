"""fdtctl — run / monitor / configure CLI.

A copy of firedancer_tpu/app/fdtctl.py.  Its topologies run on the CUDA
card: fdtctl has no device flag, so on a host without one `run` exits
non-zero with "no CUDA device" before it makes a workspace.  `configure`
runs the port's device stage (app/configure.py); the JAX package's other
stages (/dev/shm, ulimit, the XLA cache, keys) are not ported, and naming
one exits 2.  Like JAX's, `run --full` passes no funk, so its banks are
fee-only.

Reference model: the fdctl binary (src/app/fdctl/main.c): `run` boots the
topology from a config file, `monitor` attaches to a running one and
prints live rates.  Usage:

    python -m firedancer_tpu_torch.app.fdtctl run --config cfg.toml [--keyfile k]
    python -m firedancer_tpu_torch.app.fdtctl monitor --name fdt
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import tempfile
import time
from pathlib import Path

#: the stages `configure` runs (app/configure.py)
STAGES = ("device",)


def cmd_run(args) -> int:
    from . import config as C
    from ..utils import log
    from .monitor import Monitor

    text = Path(args.config).read_text() if args.config else ""
    cfg = C.parse(text)
    log.init(path=args.log_path, stderr_level="NOTICE")
    if args.keyfile:
        identity = Path(args.keyfile).read_bytes()[:32]
    else:
        identity = os.urandom(32)
    if args.full:
        topo, handles = C.build_validator_topology(
            cfg, identity, args.blockstore
            or os.path.join(tempfile.gettempdir(), f"fdt_{cfg.name}_store")
        )
        qt = handles["net"]
    else:
        topo, qt = C.build_ingress_topology(cfg, identity)
    try:
        topo.build()
        topo.start()
        if args.full:
            log.notice(
                "workspace %r: quic %s udp %s metrics %s rpc %s",
                cfg.name, qt.quic_addr, qt.udp_addr,
                handles["metric"].addr, handles["rpc"].addr,
            )
        else:
            log.notice(
                "workspace %r: quic %s udp %s",
                cfg.name, qt.quic_addr, qt.udp_addr,
            )
        stop = []
        signal.signal(signal.SIGINT, lambda *a: stop.append(1))
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        mon = Monitor(cfg.name)
        prev = None
        try:
            while not stop:
                topo.poll_failure()
                cur = mon.snapshot()
                print(mon.render(prev, cur, 1.0), flush=True)
                prev = cur
                if args.iterations:
                    args.iterations -= 1
                    if args.iterations <= 0:
                        break
                time.sleep(1.0)
        finally:
            mon.wksp.close()
    finally:
        topo.halt()
        topo.close()
    return 0


def cmd_configure(args) -> int:
    from . import configure as CF

    stages = tuple(args.stages.split(",")) if args.stages else STAGES
    missing = [s for s in stages if s not in STAGES]
    if missing:
        print(f"fdtctl configure: stages {missing} are not ported (the port "
              f"has {', '.join(STAGES)})", file=sys.stderr)
        return 2
    results = [CF.stage_device()]
    bad = 0
    for r in results:
        print(f"[{'ok' if r.ok else '!!'}] {r.name:8s} {r.detail}")
        bad += not r.ok
    return 1 if bad else 0


def cmd_monitor(args) -> int:
    from .monitor import Monitor

    Monitor(args.name).run(
        interval_s=args.interval, iterations=args.iterations
    )
    return 0


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fdtctl")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="boot the ingress topology from config")
    pr.add_argument("--config", default=None)
    pr.add_argument("--keyfile", default=None)
    pr.add_argument("--full", action="store_true",
                    help="full validator topology (net..store+metric+rpc)")
    pr.add_argument("--blockstore", default=None)
    pr.add_argument("--log-path", default=None)
    pr.add_argument("--iterations", type=int, default=0,
                    help="exit after N monitor prints (0 = run forever)")
    pm = sub.add_parser("monitor", help="attach to a running topology")
    pm.add_argument("--name", default="fdt")
    pm.add_argument("--interval", type=float, default=1.0)
    pm.add_argument("--iterations", type=int, default=None)
    pc = sub.add_parser("configure", help="system setup stages (check/init)")
    pc.add_argument("mode", nargs="?", default="check",
                    choices=("check", "init"))
    pc.add_argument("--stages", default=None,
                    help="comma-separated subset (default: all)")
    pc.add_argument("--keyfile", default=None)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return {
        "run": cmd_run, "monitor": cmd_monitor, "configure": cmd_configure,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
