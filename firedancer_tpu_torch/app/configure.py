"""The port's device stage of `configure`: is this host ready to run the
port's kernels?

The counterpart of firedancer_tpu/app/configure.py's `_stage_device` (the
other stages there, /dev/shm, ulimit, keys, concern the host runtime and are
not ported).  The report names the CUDA devices with their compute
capability, whether a card takes the kernels' sm_90a target (compute
capability 9.0) and whether nvcc builds an empty kernel for it, where nvcc
is, and the kernel cache (utils/kbuild.py's _build/, the counterpart of
the XLA compilation cache) with its entry count.  It reports and never
crashes, as the JAX stage does.

    python -m firedancer_tpu_torch.app.configure
"""

from __future__ import annotations

import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path

#: the kernels' target (utils/kbuild.py) and the capability it runs on
TARGET = "sm_90a"
TARGET_CAPABILITY = (9, 0)


@dataclass
class StageResult:
    name: str
    ok: bool
    detail: str


def _nvcc_builds_target(nvcc: str) -> bool:
    """Does nvcc compile an empty kernel for sm_90a?  (`nvcc
    --list-gpu-code` leaves the architecture-specific targets out.)"""
    with tempfile.TemporaryDirectory() as d:
        src = Path(d) / "probe.cu"
        src.write_text("__global__ void probe() {}\n")
        res = subprocess.run(
            [nvcc, "-gencode", f"arch=compute_90a,code={TARGET}", "-cubin",
             "-o", str(Path(d) / "probe.cubin"), str(src)],
            capture_output=True, text=True, timeout=120)
    return res.returncode == 0


def stage_device() -> StageResult:
    """ok when a card of capability 9.0 is visible and nvcc can build
    sm_90a.  There is nothing to fix ahead of time: kbuild makes the cache
    at the first build."""
    try:
        import torch

        from ..utils import kbuild

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        cards = [
            (torch.cuda.get_device_name(i), torch.cuda.get_device_capability(i))
            for i in range(n)
        ]
        parts = [
            f"cuda: {n} device(s)"
            + "".join(f"; {i}: {name} sm_{a}{b}"
                      for i, (name, (a, b)) in enumerate(cards))
        ]
        try:
            nvcc = kbuild.nvcc()
            nvcc_ok = _nvcc_builds_target(nvcc)
            parts.append(f"nvcc {nvcc} ({TARGET} "
                         + ("builds" if nvcc_ok else "does not build") + ")")
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            nvcc_ok = False
            parts.append(f"nvcc: {e}")
        on_card = any(cap == TARGET_CAPABILITY for _, cap in cards)
        parts.append(f"{TARGET} card: {'yes' if on_card else 'no'}")
        entries = (len([p for p in kbuild.BUILD.iterdir() if p.is_dir()])
                   if kbuild.BUILD.is_dir() else 0)
        parts.append(f"kernel cache {kbuild.BUILD} ({entries} entries)")
        return StageResult("device", on_card and nvcc_ok, "; ".join(parts))
    except Exception as e:  # noqa: BLE001 — report, don't crash configure
        return StageResult("device", False, f"device probe failed: {e!r}")


if __name__ == "__main__":
    r = stage_device()
    print(f"{r.name}: {'ok' if r.ok else 'FAIL'}: {r.detail}")
