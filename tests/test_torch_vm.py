"""The port's sBPF loader and VM (firedancer_tpu_torch/ballet/sbpf.py,
flamenco/vm.py) against the JAX package's, exactly.

Every test function of the JAX package's test_sbpf_vm.py and
test_sbpf_diff.py (its random-program differential, 600 programs a seed)
runs as written, its own assertions on the JAX modules holding, under a
mirror: each sbpf.load also runs the port's loader on the same ELF bytes
(the Program's fields, or the error, must be equal), and each run of a
JAX Vm with only the default syscalls also runs a port Vm built from the
same program, limits, memory and registers just before the run; the
return value or the error, the registers, the stack, heap and input
memory, the compute units left, the logs and the trace must be equal.
VMs the runtime makes (with its syscalls registered) are mirrored at the
executor by tests/test_torch_runtime.py."""

import dataclasses
import importlib
import inspect
import sys
from pathlib import Path

import pytest

from firedancer_tpu.ballet import sbpf as SJ
from firedancer_tpu.flamenco import vm as VJ
from firedancer_tpu_torch.ballet import sbpf as ST
from firedancer_tpu_torch.flamenco import vm as VT

TESTS = Path(__file__).resolve().parent
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

MODULES = ("test_sbpf_vm", "test_sbpf_diff")


def _cases():
    out = []
    for name in MODULES:
        mod = importlib.import_module(name)
        for fn, obj in vars(mod).items():
            if not (fn.startswith("test_") and callable(obj)):
                continue
            marks = getattr(obj, "pytestmark", [])
            if any(m.name == "slow" for m in marks):
                continue
            params = [m for m in marks if m.name == "parametrize"]
            if params:
                argname, values = params[0].args[:2]
                out += [(name, fn, {argname: v}) for v in values]
            else:
                out.append((name, fn, {}))
    return out


def _outcome(fn, *a):
    try:
        return ("ok", fn(*a))
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return (type(e).__name__, str(e))


def _program(p) -> dict:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def vm_state(vm) -> dict:
    return {"reg": list(vm.reg), "stack": bytes(vm.stack), "heap": bytes(vm.heap),
            "input": bytes(vm.input_mem), "cu": vm.cu, "logs": list(vm.logs),
            "trace": list(vm.trace_log), "call_depth": vm.call_depth}


@pytest.fixture
def vm_mirror(monkeypatch):
    """-> counts of the mirrored loads and runs."""
    counts = {"load": 0, "run": 0}
    load = SJ.load

    def mirrored_load(elf):
        got = _outcome(ST.load, elf)
        counts["load"] += 1
        try:
            want = load(elf)
        except Exception as e:
            assert got == (type(e).__name__, str(e))
            raise
        assert got[0] == "ok" and _program(got[1]) == _program(want)
        return want

    monkeypatch.setattr(SJ, "load", mirrored_load)
    run = VJ.Vm.run
    default = set(VJ.Vm(SJ.Program(b"", 0, b"")).syscalls)

    def mirrored_run(self):
        if set(self.syscalls) != default:
            return run(self)
        twin = VT.Vm(ST.Program(**_program(self.prog)), heap_sz=self.heap_sz,
                     cu_limit=self.cu_limit, input_mem=bytearray(self.input_mem),
                     trace=self.trace, trace_limit=self.trace_limit)
        twin.reg, twin.cu = list(self.reg), self.cu
        twin.stack, twin.heap = bytearray(self.stack), bytearray(self.heap)
        assert vm_state(twin) == vm_state(self)
        got = _outcome(VT.Vm.run, twin)
        counts["run"] += 1
        try:
            want = run(self)
        except Exception as e:
            assert got == (type(e).__name__, str(e))
            assert vm_state(twin) == vm_state(self)
            raise
        assert got == ("ok", want)
        assert vm_state(twin) == vm_state(self)
        return want

    monkeypatch.setattr(VJ.Vm, "run", mirrored_run)
    return counts


@pytest.mark.parametrize("module,fn,kw", _cases(),
                         ids=[f"{m}-{f}-{kw}" for m, f, kw in _cases()])
def test_vm_matches_jax(module, fn, kw, vm_mirror):
    f = getattr(importlib.import_module(module), fn)
    assert not set(inspect.signature(f).parameters) - set(kw)
    f(**kw)
    assert vm_mirror["load"] or vm_mirror["run"], "the case ran no VM"


def test_disasm_and_syscall_hashes_match_jax():
    import numpy as np

    rng = np.random.default_rng(3)
    for _ in range(512):
        ins = rng.integers(0, 256, 8, np.uint8).tobytes()
        assert _outcome(VT.disasm, ins) == _outcome(VJ.disasm, ins)
    for name in (b"sol_log_", b"sol_log_64_", b"sol_memcpy_", b"abort", b"sol_sha256",
                 b"sol_keccak256", b"sol_invoke_signed_c"):
        assert ST.syscall_hash(name) == SJ.syscall_hash(name)
