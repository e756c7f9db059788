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
                   "tango/native/fdt_pack.h", "tango/native/fdt_stem.c",
                   "tango/native/fdt_stem.h", "tango/native/fdt_sha256.c",
                   "tango/native/fdt_sha256.h", "tango/native/fdt_poh.c",
                   "tango/native/fdt_poh.h", "tango/native/fdt_shred.c",
                   "tango/native/fdt_shred.h", "tango/native/fdt_net.c",
                   "tango/native/fdt_net.h", "tango/native/fdt_bank.c",
                   "tango/native/fdt_bank.h"):
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
    for want in ("tiles/bench.py", "ballet/shred.py", "ballet/bmtree.py",
                 "ballet/hmac.py", "disco/shredder.py", "disco/fec_resolver.py",
                 "tiles/sign.py", "tiles/poh.py", "tiles/shred.py", "tiles/store.py",
                 "waltz/udpsock.py", "waltz/ip.py", "waltz/x509.py", "waltz/tls.py",
                 "waltz/quic.py", "waltz/admission.py", "ballet/aes.py",
                 "ballet/x25519.py", "ballet/chacha20.py", "tango/lru.py",
                 "tiles/net.py", "tiles/quic.py", "funk/funk.py", "flamenco/accounts.py",
                 "flamenco/features.py", "flamenco/sysvar.py", "flamenco/runtime.py",
                 "flamenco/vm.py", "ballet/murmur3.py", "ballet/sbpf.py",
                 "ballet/secp256k1.py", "ballet/http.py", "tiles/metric.py",
                 "tiles/rpc.py", "utils/log.py", "app/config.py", "app/fdtctl.py",
                 "app/monitor.py", "disco/profile.py", "disco/handshake.py"):
        assert f"firedancer_tpu_torch/{want}" in rel


NATIVE_FILES = sorted(
    p for p in (ROOT / "firedancer_tpu_torch").rglob("*")
    if p.suffix in (".c", ".h", ".cu", ".cuh")
)


@pytest.mark.parametrize(
    "path", NATIVE_FILES, ids=[str(p.relative_to(ROOT)) for p in NATIVE_FILES]
)
def test_native_source_includes_only_port_files(path):
    """Every quoted #include of a C or CUDA source of the port resolves to a
    file of the port, and none names a path into firedancer_tpu/; a copy in
    tango/native/ names its original in its header comment."""
    port = ROOT / "firedancer_tpu_torch"
    text = path.read_text()
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("#include"):
            continue
        assert "firedancer_tpu/" not in line, f"{path.name}: {line}"
        if '"' in line:
            target = (path.parent / line.split('"')[1]).resolve()
            assert target.is_file() and port in target.parents, f"{path.name}: {line}"
    if path.parent == port / "tango" / "native":
        assert f"firedancer_tpu/tango/native/{path.name}" in "".join(
            text.splitlines(keepends=True)[:4])


def _entry_calls():
    from firedancer_tpu_torch import bench, entry
    from firedancer_tpu_torch.app import config as C
    from firedancer_tpu_torch.ballet import bmtree as BM
    from firedancer_tpu_torch.ballet import hmac as H
    from firedancer_tpu_torch.disco import fec_resolver as FR
    from firedancer_tpu_torch.disco import shredder as SD
    from firedancer_tpu_torch.tiles import bench as TB
    from firedancer_tpu_torch.tiles.shred import ShredTile
    from firedancer_tpu_torch.tiles.store import StoreTile
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
        "make_transfer_pool": lambda: TB.make_transfer_pool(2, n_signers=1),
        "hmac_batch": lambda: H.hmac_batch(
            "sha256", z((1, 4), np.uint8), z((1, 4), np.uint8), [4]),
        "hmac_sha256": lambda: H.hmac_sha256(b"k", b"m"),
        "hmac_sha512": lambda: H.hmac_sha512(b"k", b"m"),
        "bmtree_hash_leaves": lambda: BM.hash_leaves([b"a"]),
        "bmtree_layers_of": lambda: BM.layers_of([b"a"]),
        "bmtree_commit": lambda: BM.commit([b"a"]),
        "bmtree_inclusion_proof": lambda: BM.inclusion_proof([b"a", b"b"], 0),
        "bmtree_root_from_proof": lambda: BM.root_from_proof(bytes(20), 0, []),
        "bmtree_verify_inclusion": lambda: BM.verify_inclusion(b"a", 0, [], bytes(20)),
        "Shredder": lambda: SD.Shredder(1),
        "FecResolver": lambda: FR.FecResolver(),
        "shred_merkle_root": lambda: FR.shred_merkle_root(None, b""),
        "ShredTile": lambda: ShredTile(),
        "StoreTile": lambda: StoreTile("/nonexistent/never-made"),
        "build_validator_topology": lambda: C.build_validator_topology(
            C.parse(""), key, "/nonexistent/never-made"),
        "build_ingress_topology": lambda: C.build_ingress_topology(C.parse(""), key),
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
    "make_transfer_pool", "hmac_batch", "hmac_sha256", "hmac_sha512",
    "bmtree_hash_leaves", "bmtree_layers_of", "bmtree_commit",
    "bmtree_inclusion_proof", "bmtree_root_from_proof", "bmtree_verify_inclusion",
    "Shredder", "FecResolver", "shred_merkle_root", "ShredTile", "StoreTile",
    "build_validator_topology", "build_ingress_topology",
])


def test_entry_point_list_is_complete():
    assert sorted(_entry_calls()) == ENTRY_POINTS


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_without_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_calls()[name]()
