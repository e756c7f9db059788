"""sBPF virtual machine interpreter.

A copy of firedancer_tpu/flamenco/vm.py.

Reference model: src/flamenco/vm/fd_vm_interp.c (computed-goto dispatch
over the sBPF instruction set), fd_vm_context.c (memory map), and
fd_vm_syscalls.c.  This is a host-side Python interpreter covering the
base integer ISA the loader emits — execution is control-plane work here
(the TPU data plane is verify/dedup); the per-instruction dict dispatch is
the honest Python analog of the reference's jump table, with the same
register file shape, memory regions, and compute-unit metering.

ISA covered: ALU64/ALU32 (add sub mul div or and lsh rsh neg mod xor mov
arsh), LD_IMM64, LDX/ST/STX {b,h,w,dw}, all JMP/JMP32 conditions, CALL
(registered syscalls by murmur3 id), CALLX, EXIT.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ballet.sbpf import (
    MM_HEAP, MM_INPUT, MM_PROGRAM, MM_STACK, Program, syscall_hash,
)

U64 = (1 << 64) - 1
U32 = (1 << 32) - 1

STACK_FRAME_SZ = 4096
MAX_CALL_DEPTH = 64


class VmError(Exception):
    pass


def _s64(x: int) -> int:
    return x - (1 << 64) if x & (1 << 63) else x


def _s32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x & (1 << 31) else x


@dataclass
class Vm:
    prog: Program
    heap_sz: int = 32 * 1024
    cu_limit: int = 200_000
    input_mem: bytearray = field(default_factory=bytearray)
    #: per-instruction tracer (fd_vm_trace.c analog): records
    #: (pc, opcode, regs snapshot) up to trace_limit entries
    trace: bool = False
    trace_limit: int = 65536

    def __post_init__(self):
        self.reg = [0] * 11
        self.stack = bytearray(STACK_FRAME_SZ * MAX_CALL_DEPTH)
        self.heap = bytearray(self.heap_sz)
        self.cu = self.cu_limit
        self.logs: list[bytes] = []
        self.trace_log: list[tuple[int, int, tuple[int, ...]]] = []
        self.call_depth = 0
        self._ret_stack: list[int] = []
        self.syscalls: dict[int, callable] = {}
        self._register_default_syscalls()
        self.reg[1] = MM_INPUT
        self.reg[10] = MM_STACK + STACK_FRAME_SZ  # frame pointer

    # ---- memory map -----------------------------------------------------

    def _region(self, addr: int, sz: int):
        """Map a VM address to (buffer, offset, writable)."""
        for base, buf, writable in (
            (MM_PROGRAM, self.prog.rodata, False),
            (MM_STACK, self.stack, True),
            (MM_HEAP, self.heap, True),
            (MM_INPUT, self.input_mem, True),
        ):
            off = addr - base
            if 0 <= off and off + sz <= len(buf):
                return buf, off, writable
        raise VmError(f"memory access violation at {addr:#x} sz {sz}")

    def mem_read(self, addr: int, sz: int) -> int:
        buf, off, _ = self._region(addr, sz)
        return int.from_bytes(buf[off : off + sz], "little")

    def mem_read_bytes(self, addr: int, sz: int) -> bytes:
        if sz == 0:
            return b""
        buf, off, _ = self._region(addr, sz)
        return bytes(buf[off : off + sz])

    def mem_write(self, addr: int, sz: int, val: int) -> None:
        buf, off, writable = self._region(addr, sz)
        if not writable:
            raise VmError(f"write to read-only memory at {addr:#x}")
        buf[off : off + sz] = (val & ((1 << (8 * sz)) - 1)).to_bytes(
            sz, "little"
        )

    # ---- syscalls -------------------------------------------------------

    def register_syscall(self, name: bytes, fn) -> None:
        self.syscalls[syscall_hash(name)] = fn

    def _register_default_syscalls(self) -> None:
        # per-syscall CU costs beyond the flat call cost (reference:
        # fd_vm_syscalls.c cost model — hashes charge base + per-byte)
        def sol_log(vm, r1, r2, r3, r4, r5):
            vm.consume(max(r2, 100))
            vm.logs.append(vm.mem_read_bytes(r1, r2))
            return 0

        def sol_log_64(vm, r1, r2, r3, r4, r5):
            vm.consume(100)
            vm.logs.append(
                b"%x %x %x %x %x" % (r1, r2, r3, r4, r5)
            )
            return 0

        def sol_log_pubkey(vm, r1, r2, r3, r4, r5):
            vm.consume(100)
            from ..ballet import base58

            vm.logs.append(base58.encode_32(vm.mem_read_bytes(r1, 32)).encode())
            return 0

        def sol_memcpy(vm, r1, r2, r3, r4, r5):
            vm.consume(r3 // 250 + 1)
            data = vm.mem_read_bytes(r2, r3)
            vm.mem_write_bytes(r1, data)
            return 0

        def sol_memset(vm, r1, r2, r3, r4, r5):
            vm.consume(r3 // 250 + 1)
            vm.mem_write_bytes(r1, bytes([r2 & 0xFF]) * r3)
            return 0

        def sol_memcmp(vm, r1, r2, r3, r4, r5):
            vm.consume(r3 // 250 + 1)
            a = vm.mem_read_bytes(r1, r3)
            b = vm.mem_read_bytes(r2, r3)
            diff = 0
            for x, y in zip(a, b):
                if x != y:
                    diff = (x - y) & 0xFFFFFFFF
                    break
            vm.mem_write(r4, 4, diff)
            return 0

        def _hash_syscall(hasher, base_cost, byte_cost):
            def syscall(vm, r1, r2, r3, r4, r5):
                # r1 = &[(addr, len)] slice vector, r2 = count,
                # r3 = result address (32 bytes out)
                vm.consume(base_cost)
                h = hasher()
                for i in range(r2):
                    addr = vm.mem_read(r1 + 16 * i, 8)
                    ln = vm.mem_read(r1 + 16 * i + 8, 8)
                    vm.consume(ln * byte_cost // 100)
                    h.update(vm.mem_read_bytes(addr, ln))
                vm.mem_write_bytes(r3, h.digest())
                return 0

            return syscall

        import hashlib

        from ..ops.keccak256 import digest_host

        class _Keccak:
            def __init__(self):
                self._buf = b""

            def update(self, b):
                self._buf += b

            def digest(self):
                return digest_host(self._buf)

        def abort(vm, r1, r2, r3, r4, r5):
            raise VmError("abort() called")

        self.register_syscall(b"sol_log_", sol_log)
        self.register_syscall(b"sol_log_64_", sol_log_64)
        self.register_syscall(b"sol_log_pubkey", sol_log_pubkey)
        self.register_syscall(b"sol_memcpy_", sol_memcpy)
        self.register_syscall(b"sol_memset_", sol_memset)
        self.register_syscall(b"sol_memcmp_", sol_memcmp)
        self.register_syscall(
            b"sol_sha256", _hash_syscall(hashlib.sha256, 85, 1)
        )
        self.register_syscall(
            b"sol_keccak256", _hash_syscall(_Keccak, 85, 1)
        )
        self.register_syscall(b"abort", abort)

    def consume(self, cus: int) -> None:
        """Charge compute units (syscall cost model)."""
        self.cu -= int(cus)
        if self.cu < 0:
            raise VmError("compute budget exceeded")

    def mem_write_bytes(self, addr: int, data: bytes) -> None:
        if not data:
            return
        buf, off, writable = self._region(addr, len(data))
        if not writable:
            raise VmError(f"write to read-only memory at {addr:#x}")
        buf[off : off + len(data)] = data

    # ---- interpreter ----------------------------------------------------

    def run(self) -> int:
        """Execute from the entrypoint; returns r0.  Raises VmError on
        fault or CU exhaustion."""
        text = self.prog.text
        n_ins = len(text) // 8
        pc = self.prog.entry_pc
        reg = self.reg
        while True:
            if not 0 <= pc < n_ins:
                raise VmError(f"pc out of bounds: {pc}")
            self.cu -= 1
            if self.cu < 0:
                raise VmError("compute budget exceeded")
            ins = text[8 * pc : 8 * pc + 8]
            op = ins[0]
            dst = ins[1] & 0xF
            src = ins[1] >> 4
            off = int.from_bytes(ins[2:4], "little", signed=True)
            imm = int.from_bytes(ins[4:8], "little", signed=True)
            cls = op & 7
            if self.trace and len(self.trace_log) < self.trace_limit:
                self.trace_log.append((pc, op, tuple(reg)))
            pc += 1

            if op == 0x18:  # lddw
                if pc >= n_ins:
                    raise VmError("truncated lddw")
                hi = int.from_bytes(text[8 * pc + 4 : 8 * pc + 8], "little")
                reg[dst] = ((imm & U32) | (hi << 32)) & U64
                pc += 1
            elif cls in (0x07, 0x04):  # ALU64 / ALU32
                is64 = cls == 0x07
                b = reg[src] if op & 0x08 else imm & (U64 if is64 else U32)
                a = reg[dst] if is64 else reg[dst] & U32
                if not is64:
                    b &= U32
                code = op & 0xF0
                if code == 0x00:
                    r = a + b
                elif code == 0x10:
                    r = a - b
                elif code == 0x20:
                    r = a * b
                elif code == 0x30:
                    if b == 0:
                        raise VmError("division by zero")
                    r = a // b
                elif code == 0x40:
                    r = a | b
                elif code == 0x50:
                    r = a & b
                elif code == 0x60:
                    r = a << (b & (63 if is64 else 31))
                elif code == 0x70:
                    r = a >> (b & (63 if is64 else 31))
                elif code == 0x80:  # neg
                    r = -a
                elif code == 0x90:
                    if b == 0:
                        raise VmError("division by zero")
                    r = a % b
                elif code == 0xA0:
                    r = a ^ b
                elif code == 0xB0:
                    r = b
                elif code == 0xC0:  # arsh
                    sa = _s64(a) if is64 else _s32(a)
                    r = sa >> (b & (63 if is64 else 31))
                else:
                    raise VmError(f"bad ALU opcode {op:#x}")
                reg[dst] = r & (U64 if is64 else U32)
            elif cls == 0x05 or cls == 0x06:  # JMP / JMP32
                is64 = cls == 0x05
                if op == 0x05:  # ja
                    pc += off
                    continue
                if op == 0x85:  # call: registered syscall, else bpf-to-bpf
                    fnid = imm & U32
                    if fnid in self.syscalls:
                        self._call(imm)
                    else:
                        self.call_depth += 1
                        if self.call_depth >= MAX_CALL_DEPTH:
                            raise VmError("call depth exceeded")
                        self._ret_stack.append(pc)
                        reg[10] += STACK_FRAME_SZ
                        pc += imm  # relative target (signed imm)
                    continue
                if op == 0x8D:  # callx: indirect bpf-to-bpf via reg[imm]
                    if not 0 <= imm < 11:
                        raise VmError(f"callx bad register r{imm}")
                    tgt = reg[imm]
                    rel = tgt - MM_PROGRAM - self.prog.text_addr
                    if rel < 0 or rel % 8 or rel // 8 >= n_ins:
                        raise VmError(f"callx target oob {tgt:#x}")
                    self.call_depth += 1
                    if self.call_depth >= MAX_CALL_DEPTH:
                        raise VmError("call depth exceeded")
                    self._ret_stack.append(pc)
                    reg[10] += STACK_FRAME_SZ
                    pc = rel // 8
                    continue
                if op == 0x95:  # exit
                    if self._ret_stack:
                        pc = self._ret_stack.pop()
                        self.call_depth -= 1
                        reg[10] -= STACK_FRAME_SZ
                        continue
                    return reg[0]
                a = reg[dst] if is64 else reg[dst] & U32
                b = reg[src] if op & 0x08 else imm & (U64 if is64 else U32)
                if not is64:
                    b &= U32
                sa = _s64(a) if is64 else _s32(a)
                sb = (_s64(b) if is64 else _s32(b)) if op & 0x08 else imm
                code = op & 0xF0
                taken = {
                    0x10: a == b,
                    0x20: a > b,
                    0x30: a >= b,
                    0xA0: a < b,
                    0xB0: a <= b,
                    0x40: bool(a & b),
                    0x50: a != b,
                    0x60: sa > sb,
                    0x70: sa >= sb,
                    0xC0: sa < sb,
                    0xD0: sa <= sb,
                }.get(code)
                if taken is None:
                    raise VmError(f"bad JMP opcode {op:#x}")
                if taken:
                    pc += off
            elif cls in (0x01, 0x02, 0x03):  # LDX / ST / STX
                sz = {0x10: 1, 0x08: 2, 0x00: 4, 0x18: 8}[op & 0x18]
                if cls == 0x01:  # ldx
                    reg[dst] = self.mem_read((reg[src] + off) & U64, sz)
                elif cls == 0x02:  # st imm
                    self.mem_write((reg[dst] + off) & U64, sz, imm & U64)
                else:  # stx
                    self.mem_write((reg[dst] + off) & U64, sz, reg[src])
            else:
                raise VmError(f"unknown opcode {op:#x}")
        raise AssertionError("unreachable")

    def _call(self, imm: int) -> None:
        fn = self.syscalls.get(imm & U32)
        if fn is None:
            raise VmError(f"unknown syscall {imm & U32:#x}")
        self.cu -= 100
        if self.cu < 0:
            raise VmError("compute budget exceeded")
        self.reg[0] = (
            fn(self, *(self.reg[1:6])) or 0
        ) & U64


# ---------------------------------------------------------------------------
# disassembler + trace formatting (fd_vm_disasm.c / fd_vm_trace.c analogs)
# ---------------------------------------------------------------------------

_ALU_NAMES = {0x00: "add", 0x10: "sub", 0x20: "mul", 0x30: "div",
              0x40: "or", 0x50: "and", 0x60: "lsh", 0x70: "rsh",
              0x80: "neg", 0x90: "mod", 0xA0: "xor", 0xB0: "mov",
              0xC0: "arsh"}
_JMP_NAMES = {0x00: "ja", 0x10: "jeq", 0x20: "jgt", 0x30: "jge",
              0x40: "jset", 0x50: "jne", 0x60: "jsgt", 0x70: "jsge",
              0xA0: "jlt", 0xB0: "jle", 0xC0: "jslt", 0xD0: "jsle"}
_SIZES = {0x10: "b", 0x08: "h", 0x00: "w", 0x18: "dw"}


def disasm(ins: bytes) -> str:
    """One 8-byte instruction -> assembly-ish text."""
    op = ins[0]
    dst = ins[1] & 0xF
    src = ins[1] >> 4
    off = int.from_bytes(ins[2:4], "little", signed=True)
    imm = int.from_bytes(ins[4:8], "little", signed=True)
    cls = op & 7
    if op == 0x18:
        return f"lddw r{dst}, {imm:#x}(lo)"
    if op == 0x85:
        return f"call {imm:#x}"
    if op == 0x8D:
        return f"callx r{imm & 0xF}"
    if op == 0x95:
        return "exit"
    if cls in (0x07, 0x04):
        name = _ALU_NAMES.get(op & 0xF0, f"alu{op:#x}")
        w = "64" if cls == 0x07 else "32"
        rhs = f"r{src}" if op & 0x08 else f"{imm}"
        return f"{name}{w} r{dst}, {rhs}"
    if cls in (0x05, 0x06):
        name = _JMP_NAMES.get(op & 0xF0, f"jmp{op:#x}")
        if name == "ja":
            return f"ja {off:+d}"
        rhs = f"r{src}" if op & 0x08 else f"{imm}"
        return f"{name} r{dst}, {rhs}, {off:+d}"
    if cls == 0x01:
        return f"ldx{_SIZES[op & 0x18]} r{dst}, [r{src}{off:+d}]"
    if cls == 0x02:
        return f"st{_SIZES[op & 0x18]} [r{dst}{off:+d}], {imm}"
    if cls == 0x03:
        return f"stx{_SIZES[op & 0x18]} [r{dst}{off:+d}], r{src}"
    return f".quad {int.from_bytes(ins, 'little'):#x}"


def format_trace(vm: "Vm", limit: int | None = None) -> str:
    """Rendered instruction trace of a traced run (fd_vm_trace output
    shape: pc, disassembly, registers)."""
    out = []
    text = vm.prog.text
    for pc, _op, regs in vm.trace_log[: limit or len(vm.trace_log)]:
        ins = text[8 * pc : 8 * pc + 8]
        rs = " ".join(f"r{i}={regs[i]:#x}" for i in range(11))
        out.append(f"{pc:6d}: {disasm(ins):<28} {rs}")
    return "\n".join(out)
