"""utils/kbuild.py with a stand-in nvcc (a script that writes its -o file
and a ptxas-style line): every source builds, an unchanged source is
reused, an edited source or shared header rebuilds, and a failed build
raises with its log."""

import os
import stat
import sys

import pytest

from firedancer_tpu_torch.utils import kbuild

FAKE_NVCC = """\
import pathlib, sys
args = sys.argv[1:]
src = pathlib.Path(args[-1])
text = src.read_text()
calls = pathlib.Path(__file__).with_name("calls")
with calls.open("a") as f:
    f.write(src.stem + "\\n")
if "error" in text:
    print(f"{src}: error: bad source")
    sys.exit(1)
pathlib.Path(args[args.index("-o") + 1]).write_text(text)
print("ptxas info    : Used 40 registers")
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    script = bindir / "nvcc"
    script.write_text(f"#!{sys.executable}\n{FAKE_NVCC}")
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kbuild, "CSRC", csrc)
    monkeypatch.setattr(kbuild, "BUILD", tmp_path / "build")
    return csrc, bindir / "calls"


def test_build_all_builds_each_source_once(fake):
    csrc, calls = fake
    (csrc / "a.cu").write_text("kernel a")
    (csrc / "b.cu").write_text("kernel b")
    assert kbuild.build_all() == ["a", "b"]
    for n in ("a", "b"):
        assert kbuild.library_path(n).read_text() == f"kernel {n}"
        assert "registers" in kbuild.build_log(n)
    assert sorted(calls.read_text().split()) == ["a", "b"]
    kbuild.build_all()  # both built: nvcc is not run again
    assert sorted(calls.read_text().split()) == ["a", "b"]
    (csrc / "a.cu").write_text("kernel a, edited")
    kbuild.build_all(["a"])
    assert kbuild.library_path("a").read_text() == "kernel a, edited"
    assert sorted(calls.read_text().split()) == ["a", "a", "b"]


def test_failed_build_raises_and_leaves_no_library(fake):
    csrc, _ = fake
    (csrc / "bad.cu").write_text("error")
    with pytest.raises(RuntimeError, match="bad source"):
        kbuild.build_all()
    assert not kbuild.library_path("bad").exists()
    assert list(kbuild.library_path("bad").parent.iterdir()) == []


def test_edited_header_rebuilds_every_source(fake):
    csrc, calls = fake
    (csrc / "shared.cuh").write_text("// v1")
    (csrc / "a.cu").write_text('#include "shared.cuh"')
    (csrc / "b.cu").write_text('#include "shared.cuh"')
    kbuild.build_all()
    before = {n: kbuild.library_path(n) for n in ("a", "b")}
    (csrc / "shared.cuh").write_text("// v2")
    assert not any(kbuild.library_path(n).exists() for n in ("a", "b"))
    kbuild.build_all()
    for n in ("a", "b"):
        assert kbuild.library_path(n) != before[n]
        assert kbuild.library_path(n).exists()
    assert sorted(calls.read_text().split()) == ["a", "a", "b", "b"]
    (csrc / "other.cuh").write_text("// a new header")
    assert not kbuild.library_path("a").exists()


def test_probe_in_subdirectory_builds_and_disassembles(fake):
    """A probe under csrc/<dir>/ builds like a kernel but is not one of the
    path's sources; sass() runs cuobjdump (from beside nvcc) on it."""
    csrc, calls = fake
    (csrc / "a.cu").write_text("kernel a")
    (csrc / "probe").mkdir()
    (csrc / "probe" / "p.cu").write_text("probe p")
    cuobjdump = kbuild.Path(kbuild.nvcc()).parent / "cuobjdump"
    cuobjdump.write_text(f"#!{sys.executable}\nimport sys\n"
                         "print('Function : p', open(sys.argv[-1]).read())\n")
    cuobjdump.chmod(cuobjdump.stat().st_mode | stat.S_IXUSR)
    assert kbuild.sources() == ["a"]
    assert kbuild.sass("probe/p") == "Function : p probe p\n"
    assert kbuild.library_path("probe/p").name == "libp.so"
    assert "registers" in kbuild.build_log("probe/p")
    assert calls.read_text().split() == ["p"]
