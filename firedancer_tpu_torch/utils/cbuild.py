"""Host C build: compile the port's native sources into a shared library.

The counterpart of firedancer_tpu/utils/cbuild.py, trimmed to what the
port's ring library needs: one `build(name, sources)` that compiles with
the host C compiler ($CC, else cc) and returns the library's path, and
the ABI sidecar (`abi_symbols`, `sidecar_path`, `read_sidecar`): every
built library gets a `<so>.hsk` JSON beside it holding the exported fdt_*
prototypes parsed from its sources, the C half of the version-handshake
digest (tango/rings.py abi_digest).  The sanitizer builds are not
carried.  Outputs
go to the git-ignored firedancer_tpu_torch/_build/, keyed on a hash of the
sources, of the headers beside them and of the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing is written outside the
checkout (the JAX package's cache under ~/.cache is never touched).  A
build that fails raises.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
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


# ---------------------------------------------------------------------------
# ABI sidecar: the EXPORTED fdt_* prototype set of a library's sources
# (names + normalized prototypes), so a rebuild from identical sources —
# or a body-only patch — digests identically, while a symbol add/remove
# or a prototype change does not.

#: one exported (non-static) C function definition opening at line
#: start: return type words/pointers, an fdt_* name, the parameter
#: list, then `{` on the same or a following line (handled by the
#: multiline collapse in abi_symbols)
_C_EXPORT_RE = re.compile(
    r"^(?!static\b)(?P<ret>[A-Za-z_][A-Za-z0-9_ ]*[A-Za-z0-9_*]"
    r"[\s*]+)(?P<name>fdt_[a-z0-9_]+)\s*\((?P<args>[^;{)]*)\)\s*\{",
    re.MULTILINE,
)


def abi_symbols(sources: list[Path]) -> list[str]:
    """Sorted normalized `ret name(args)` prototypes for every exported
    fdt_* function defined in `sources` (.c only; headers declare, the
    definition is the export)."""
    out: set[str] = set()
    for src in sources:
        if src.suffix != ".c":
            continue
        # collapse each definition's header onto one line so the regex
        # sees multi-line parameter lists
        text = re.sub(r"\(\s*\n\s*", "(", src.read_text())
        text = re.sub(r",\s*\n\s*", ", ", text)
        for m in _C_EXPORT_RE.finditer(text):
            ret = " ".join(m.group("ret").replace("*", " * ").split())
            args = " ".join(m.group("args").replace("*", " * ").split())
            out.add(f"{ret} {m.group('name')}({args})")
    return sorted(out)


def _write_sidecar(out: Path, sources: list[Path]) -> None:
    doc = {"symbols": abi_symbols(sources)}
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".hsk")
    with os.fdopen(fd, "w") as f:
        json.dump(doc, f, sort_keys=True)
    os.replace(tmp, sidecar_path(out))


def sidecar_path(so: Path) -> Path:
    return so.with_suffix(so.suffix + ".hsk")


def read_sidecar(so: Path) -> dict | None:
    """The .hsk ABI sidecar written next to `so` at build, or None when
    the library has none."""
    try:
        with open(sidecar_path(so)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def build(name: str, sources: list) -> Path:
    """Compile `sources` into lib<name>.so (once per source hash), with its
    .hsk sidecar beside it; -> its path.  The library and the sidecar are
    each written to a temporary file and renamed into place, so
    concurrent builders never load a half-written one."""
    out = library_path(name, sources)
    if out.exists():
        if not sidecar_path(out).exists():
            _write_sidecar(out, [Path(p) for p in sources])
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
    _write_sidecar(out, [Path(p) for p in sources])
    return out
