"""Kernel builder: nvcc each CUDA source under firedancer_tpu_torch/csrc/
into its own shared library with a plain C interface, loaded with ctypes.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<hash>/lib<name>.so csrc/<name>.cu

Build happens at first use (`load(name)`) or all at once (`build_all()`, one
nvcc per source, all started together).  Outputs go to
firedancer_tpu_torch/_build/ (git-ignored), keyed on a hash of the source
text, of every shared header (csrc/*.cuh) and of the flags, so an edited
source or header rebuilds and an unchanged one is reused.  The ptxas report (registers, spills, stack per kernel) is kept
beside each library as lib<name>.log (`build_log(name)`).  A build that
fails raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: dict = {}


def nvcc() -> str:
    """Path of nvcc: $PATH first, then /usr/local/cuda/bin."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def sources() -> list:
    """Kernel names (csrc/<name>.cu), sorted."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _out_dir(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(f"\0{hdr.name}\0".encode() + hdr.read_bytes())
    h.update("\0".join(FLAGS).encode())
    return BUILD / h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return _out_dir(name) / f"lib{name}.so"


def build_log(name: str) -> str:
    """nvcc's output (the -Xptxas -v report) for the built library."""
    return (_out_dir(name) / f"lib{name}.log").read_text()


def _build(name: str) -> None:
    """nvcc `name` into a temporary directory, then rename into place: the
    log first and the library last, so a present library means a complete
    build."""
    out = _out_dir(name)
    out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        tmp = Path(tmp)
        res = subprocess.run(
            [nvcc(), *FLAGS, "-o", str(tmp / f"lib{name}.so"),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stdout}")
        (tmp / f"lib{name}.log").write_text(res.stdout)
        os.replace(tmp / f"lib{name}.log", out / f"lib{name}.log")
        os.replace(tmp / f"lib{name}.so", out / f"lib{name}.so")


def build_all(names=None) -> list:
    """Build every kernel (or `names`) not built yet, one nvcc per source,
    all started together; -> the names."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            list(pool.map(_build, todo))
    return names


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
