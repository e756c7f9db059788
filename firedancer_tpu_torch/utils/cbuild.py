"""Host C build: compile the port's native sources into a shared library.

The counterpart of firedancer_tpu/utils/cbuild.py, trimmed to what the
port's ring library needs: one `build(name, sources)` that compiles with
the host C compiler ($CC, else cc) and returns the library's path.  Outputs
go to the git-ignored firedancer_tpu_torch/_build/, keyed on a hash of the
sources, of the headers beside them and of the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is written outside the
checkout (the JAX package's cache under ~/.cache is never touched).  A
build that fails raises.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-std=c11", "-fPIC", "-shared", "-Wall", "-Wextra", "-Werror"]


def _cc() -> str:
    return os.environ.get("CC", "cc")


def library_path(name: str, sources: list) -> Path:
    h = hashlib.sha256(" ".join([_cc(), *FLAGS]).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
        for hdr in sorted(Path(src).parent.glob("*.h")):
            h.update(hdr.read_bytes())
    return BUILD / f"host-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str, sources: list) -> Path:
    """Compile `sources` into lib<name>.so (once per source hash); -> its
    path.  The library is built into a temporary file and renamed into
    place, so concurrent builders never load a half-written one."""
    out = library_path(name, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    cmd = [_cc(), *FLAGS, *map(str, sources), "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out
