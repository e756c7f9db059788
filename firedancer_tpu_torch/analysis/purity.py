"""Hot-path purity lint for the port's PyTorch code.

The counterpart of firedancer_tpu/analysis/purity.py.  Functions marked
`@hot_path` (firedancer_tpu_torch.utils.hotpath) are the device dispatch
path: PyTorch launches them asynchronously and the caller owns the one
device-to-host sync.  This pass enforces the marker's contract by AST:

  purity-host-sync  host synchronization inside a hot function:
                    `.item()`, `.cpu()`, `.tolist()`, `.numpy()`,
                    `torch.cuda.synchronize()`, `np.asarray` / `np.array` /
                    `np.frombuffer`, and `bool(x)` / `int(x)` on anything
                    but a literal or an argument declared static (a
                    tensor's truth value or integer is a sync).
  purity-float      Python float literals and float() casts: the crypto and
                    dedup math is exact integer arithmetic.

Only marked functions are checked: the host layer is free to sync (that is
its job: the pool's land, the step's owner).  There is no suppression
pragma: a function that must sync by design is not marked, and the
sync-free function below it is.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_NP_NAMES = {"np", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "frombuffer"}
_CASTS = {"bool", "int"}


@dataclass(frozen=True, order=True)
class Finding:
    """One lint violation, pinned to path:line (the shape of
    firedancer_tpu/analysis/findings.py's Finding)."""

    path: str
    line: int
    rule: str
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


def hot_path_meta(fn) -> tuple[bool, set[str]]:
    """(is_marked, static_arg_names) from a def's decorator list."""
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = getattr(target, "id", None) or getattr(target, "attr", None)
        if name != "hot_path":
            continue
        static: set[str] = set()
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "static" and isinstance(kw.value, (ast.Tuple, ast.List)):
                    static |= {el.value for el in kw.value.elts
                               if isinstance(el, ast.Constant)
                               and isinstance(el.value, str)}
        return True, static
    return False, set()


def _is_torch_cuda_sync(func) -> bool:
    """torch.cuda.synchronize"""
    return (isinstance(func, ast.Attribute) and func.attr == "synchronize"
            and isinstance(func.value, ast.Attribute) and func.value.attr == "cuda"
            and isinstance(func.value.value, ast.Name)
            and func.value.value.id == "torch")


def _host_value(arg, static: set[str]) -> bool:
    """A literal or a static argument: casting it is no sync."""
    return isinstance(arg, ast.Constant) or (
        isinstance(arg, ast.Name) and arg.id in static)


def check_function(path: str, fn, static: set[str]) -> list[Finding]:
    out: list[Finding] = []

    def add(node, rule, msg):
        out.append(Finding(path, node.lineno, rule, msg))

    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                base = func.value
                if func.attr in _SYNC_METHODS:
                    add(node, "purity-host-sync",
                        f".{func.attr}() inside @hot_path code copies to the "
                        "host and waits for the card; return the tensor and "
                        "sync at the dispatch boundary")
                elif (isinstance(base, ast.Name) and base.id in _NP_NAMES
                      and func.attr in _NP_SYNC_FUNCS):
                    add(node, "purity-host-sync",
                        f"{base.id}.{func.attr}() inside @hot_path code "
                        "materializes a value on the host; hoist it to the "
                        "caller")
                elif _is_torch_cuda_sync(func):
                    add(node, "purity-host-sync",
                        "torch.cuda.synchronize() inside @hot_path code; the "
                        "dispatch boundary owns synchronization")
            elif isinstance(func, ast.Name):
                if (func.id in _CASTS and node.args
                        and not _host_value(node.args[0], static)):
                    add(node, "purity-host-sync",
                        f"{func.id}() of a tensor inside @hot_path code waits "
                        "for the card; declare the argument static if it is "
                        "a host value")
                elif func.id == "float":
                    add(node, "purity-float",
                        "float() cast in @hot_path code: the math must stay "
                        "exact integer arithmetic")
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            add(node, "purity-float",
                f"float literal {node.value!r} in @hot_path code: the math "
                "must stay exact integer arithmetic")
    return out


def check_source(text: str, path: str = "<source>") -> tuple[list[Finding], list[str]]:
    """Lint one module's text -> (findings, names of the marked functions)."""
    tree = ast.parse(text, filename=path)
    findings: list[Finding] = []
    marked: list[str] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            is_hot, static = hot_path_meta(node)
            if is_hot:
                marked.append(node.name)
                findings.extend(check_function(path, node, static))
    return sorted(set(findings)), marked


def check_package(root: Path | None = None) -> tuple[list[Finding], dict]:
    """Lint every module of the port -> (findings, {relative path: marked
    function names})."""
    root = Path(__file__).resolve().parent.parent if root is None else root
    findings: list[Finding] = []
    marked: dict = {}
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        f, names = check_source(path.read_text(), rel)
        findings.extend(f)
        if names:
            marked[rel] = names
    return findings, marked


if __name__ == "__main__":
    found, hot = check_package()
    for f in found:
        print(f)
    print(f"{sum(map(len, hot.values()))} @hot_path functions, "
          f"{len(found)} findings")
    raise SystemExit(1 if found else 0)
