"""The PyTorch port stands alone: no file of firedancer_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package, and its entry points run on
the CUDA card unless the caller names the CPU."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "firedancer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "firedancer_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_port_has_files():
    names = {p.name for p in PORT_FILES}
    for want in ("chip_smoke.py", "verify_core.py", "msm.py", "pipeline.py", "kbuild.py"):
        assert want in names


def _entry_calls():
    from firedancer_tpu_torch.models import pipeline as PL
    from firedancer_tpu_torch.ops import pack_select
    from firedancer_tpu_torch.ops.ed25519 import verify as V

    z = np.zeros
    return {
        "verify_batch": lambda: V.verify_batch(
            z((2, 8), np.uint8), z(2, np.int32), z((2, 64), np.uint8),
            z((2, 32), np.uint8)),
        "verify_batch_digest": lambda: V.verify_batch_digest(
            z((2, 64), np.uint8), z((2, 64), np.uint8), z((2, 32), np.uint8)),
        "verify_batch_digest_on": lambda: V.verify_batch_digest_on(None),
        "verify_batch_digest_rlc": lambda: V.verify_batch_digest_rlc(
            z((2, 64), np.uint8), z((2, 64), np.uint8), z((2, 32), np.uint8)),
        "make_step": lambda: PL.make_step(),
        "AgingBloom": lambda: PL.AgingBloom(),
        "fresh_bloom": lambda: PL.fresh_bloom(),
        "select_noconflict": lambda: pack_select.select_noconflict(
            z((2, 1), np.uint64), z((2, 1), np.uint64), z(1, np.uint64),
            z(1, np.uint64), z(2, np.int64), 10, 2),
    }


ENTRY_POINTS = [
    "AgingBloom", "fresh_bloom", "make_step", "select_noconflict",
    "verify_batch", "verify_batch_digest", "verify_batch_digest_on",
    "verify_batch_digest_rlc",
]


def test_entry_point_list_is_complete():
    assert sorted(_entry_calls()) == ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_without_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls()[name]()
