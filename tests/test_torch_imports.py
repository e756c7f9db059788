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
    rel = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "firedancer_tpu_torch/tiles/verify.py" in rel
    for want in ("firedancer_tpu_torch/ballet/pack.py", "firedancer_tpu_torch/tiles/pack.py",
                 "firedancer_tpu_torch/tiles/bank.py"):
        assert want in rel
    for native in ("csrc/pack_select.cu", "tango/native/fdt_pack.c",
                   "tango/native/fdt_pack.h"):
        assert (ROOT / "firedancer_tpu_torch" / native).exists()
    for want in ("chip_smoke.py", "verify_core.py", "msm.py", "pipeline.py", "kbuild.py",
                 "sha256.py", "poh.py", "gf256.py", "reedsol.py", "sign.py",
                 "keccak256.py", "blake3.py", "entry.py", "dryrun.py", "mesh.py",
                 "bench.py", "mux.py", "configure.py", "purity.py", "hotpath.py",
                 "rings.py", "tempo.py", "cbuild.py", "metrics.py", "trace.py",
                 "topo.py", "txn.py", "wire.py", "pcap.py", "synth.py",
                 "replay.py", "dedup.py", "sink.py", "base58.py",
                 "compute_budget.py", "pack.py", "bank.py", "pack_select.py"):
        assert want in names


def _entry_calls():
    from firedancer_tpu_torch import bench, entry
    from firedancer_tpu_torch.models import pipeline as PL
    from firedancer_tpu_torch.parallel import dryrun
    from firedancer_tpu_torch.ops import blake3, keccak256, pack_select, poh, reedsol, sha256
    from firedancer_tpu_torch.ops.ed25519 import sign
    from firedancer_tpu_torch.ops.ed25519 import verify as V

    z = np.zeros
    key = bytes(32)
    return {
        "sha256": lambda: sha256.sha256(z((2, 8), np.uint8), z(2, np.int32)),
        "sha256_words32": lambda: sha256.sha256_words32(z((2, 8), np.int64)),
        "sha256_words64": lambda: sha256.sha256_words64(z((2, 16), np.int64)),
        "append_n": lambda: poh.append_n(z((2, 32), np.uint8), 3),
        "mixin": lambda: poh.mixin(z((2, 32), np.uint8), z((2, 32), np.uint8)),
        "verify_entries": lambda: poh.verify_entries(
            z((2, 32), np.uint8), z(2, np.int32), z((2, 32), np.uint8), z(2, bool), 4),
        "encode": lambda: reedsol.encode(z((2, 8), np.uint8), 2),
        "recover": lambda: reedsol.recover(z((4, 8), np.uint8), np.ones(4, bool), 2),
        "public_keys": lambda: sign.public_keys([key]),
        "sign_many": lambda: sign.sign_many([(key, b"m")]),
        "sign_batch": lambda: sign.sign_batch(key, [b"m"]),
        "keccak256": lambda: keccak256.keccak256(z((2, 8), np.uint8), z(2, np.int32)),
        "blake3": lambda: blake3.blake3(z((2, 8), np.uint8), z(2, np.int32)),
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
        "entry": lambda: entry.entry(),
        "bench": lambda: bench.bench(lanes=2, msg_len=8),
        "bench_pipeline": lambda: bench.pipeline(total=2),
        "ingress": lambda: entry.ingress(),
        "leader": lambda: entry.leader(),
        "run_verify_pool": lambda: dryrun.run_verify_pool(1, lanes=2),
        "dryrun_multichip": lambda: entry.dryrun_multichip(1),
        "run_steps": lambda: dryrun.run_steps(
            1, 1, [{"ok": z(2, bool), "tags2": z((2, 2), np.uint32)}]),
        "select_noconflict": lambda: pack_select.select_noconflict(
            z((2, 1), np.uint64), z((2, 1), np.uint64), z(1, np.uint64),
            z(1, np.uint64), z(2, np.int64), 10, 2),
    }


ENTRY_POINTS = sorted([
    "AgingBloom", "fresh_bloom", "make_step", "select_noconflict",
    "verify_batch", "verify_batch_digest", "verify_batch_digest_on",
    "verify_batch_digest_rlc",
    "sha256", "sha256_words32", "sha256_words64", "append_n", "mixin",
    "verify_entries", "encode", "recover", "public_keys", "sign_many",
    "sign_batch", "keccak256", "blake3", "entry", "bench", "bench_pipeline",
    "ingress", "leader", "run_verify_pool",
    "dryrun_multichip", "run_steps",
])


def test_entry_point_list_is_complete():
    assert sorted(_entry_calls()) == ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_without_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls()[name]()
