"""The port's hot-path purity checker (analysis/purity.py): each rule on a
known-bad snippet, the exemptions, and zero findings on the port's marked
functions, which are the counterparts of the JAX package's 11 @hot_path
functions (checked with the JAX package's own checker beside it)."""

import ast
import inspect
import textwrap
from pathlib import Path

import pytest

from firedancer_tpu.analysis import purity as PJ
from firedancer_tpu_torch.analysis import purity
from firedancer_tpu_torch.ops.ed25519 import verify as V

BAD = {
    "item": ("x.sum().item()", "purity-host-sync"),
    "cpu": ("x.cpu()", "purity-host-sync"),
    "tolist": ("x.tolist()", "purity-host-sync"),
    "numpy": ("x.numpy()", "purity-host-sync"),
    "bool": ("bool(x.any())", "purity-host-sync"),
    "int": ("int(x.sum())", "purity-host-sync"),
    "float_cast": ("float(x.sum())", "purity-float"),
    "synchronize": ("torch.cuda.synchronize()", "purity-host-sync"),
    "np_asarray": ("np.asarray(x)", "purity-host-sync"),
    "np_array": ("np.array(x)", "purity-host-sync"),
    "np_frombuffer": ("np.frombuffer(x, np.uint8)", "purity-host-sync"),
    "float_literal": ("x * 0.5", "purity-float"),
}


def _snippet(body: str, deco: str = "@hot_path") -> str:
    return textwrap.dedent(f"""
        import numpy as np
        import torch
        from firedancer_tpu_torch.utils.hotpath import hot_path

        {deco}
        def f(x, n):
            y = x + 1
            return {body}
    """)


@pytest.mark.parametrize("name", sorted(BAD))
def test_each_rule_flags_its_snippet(name):
    body, rule = BAD[name]
    findings, marked = purity.check_source(_snippet(body), "snippet.py")
    assert marked == ["f"]
    assert [f.rule for f in findings] == [rule], findings
    assert findings[0].line == 9 and findings[0].path == "snippet.py"


@pytest.mark.parametrize("name", sorted(BAD))
def test_unmarked_function_is_not_checked(name):
    findings, marked = purity.check_source(_snippet(BAD[name][0], deco=""))
    assert findings == [] and marked == []


@pytest.mark.parametrize("body", ["int(n)", "bool(n)", "int(3)", "x.shape[0] + 1"])
def test_static_and_literal_casts_are_exempt(body):
    findings, _ = purity.check_source(_snippet(body, deco='@hot_path(static=("n",))'))
    assert findings == []


#: the JAX package's @hot_path functions and their counterparts in the port
COUNTERPARTS = {
    ("ops/pack_select.py", "_select_impl"): ("ops/pack_select.py", "select_impl"),
    ("ops/sha512.py", "_sha512_impl"): ("ops/sha512.py", "sha512"),
    ("ops/ed25519/sign.py", "_base_mul_compress"): ("ops/ed25519/sign.py", "_base_mul_compress"),
    ("models/pipeline.py", "step"): ("models/pipeline.py", "step"),
    ("ops/ed25519/verify.py", "_verify_from_digest"): ("ops/ed25519/verify.py", "_verify_from_digest"),
    ("ops/ed25519/verify.py", "_verify_impl"): ("ops/ed25519/verify.py", "verify_batch"),
    # the port's _verify_digest_rlc_impl syncs on the batch verdict by
    # design; the sync-free prologue below it is marked instead
    ("ops/ed25519/verify.py", "_verify_digest_rlc_impl"): ("ops/ed25519/verify.py", "rlc_prologue"),
    ("ops/ed25519/verify.py", "_verify_digest_impl"): ("ops/ed25519/verify.py", "verify_batch_digest"),
    ("ops/ed25519/msm_kernel.py", "decompress_niels"): ("ops/ed25519/msm.py", "decompress_niels"),
    ("ops/ed25519/msm_kernel.py", "msm_check"): ("ops/ed25519/msm.py", "msm_check"),
    ("ops/ed25519/pallas_kernel.py", "verify_core"): ("ops/ed25519/verify_core.py", "verify_core"),
}

JAX_ROOT = Path(PJ.__file__).resolve().parent.parent


def test_jax_marks_the_listed_functions():
    marked = set()
    for path in sorted(JAX_ROOT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and PJ._hot_path_meta(node)[0]:
                marked.add((path.relative_to(JAX_ROOT).as_posix(), node.name))
    assert marked == set(COUNTERPARTS)


def test_port_marks_the_counterparts_and_is_clean():
    findings, marked = purity.check_package()
    assert findings == [], "\n".join(map(str, findings))
    pairs = {(p, n) for p, names in marked.items() for n in names}
    assert set(COUNTERPARTS.values()) <= pairs
    # the one function marked beyond them: the dedup half of the step
    assert pairs - set(COUNTERPARTS.values()) == {("models/pipeline.py", "dedup")}


def test_rlc_branch_sync_is_caught_if_marked():
    """Marking the RLC impl would flag its by-design sync, bool(batch_ok)."""
    src = textwrap.dedent(inspect.getsource(V._verify_digest_rlc_impl))
    fn = ast.parse(src).body[0]
    findings = purity.check_function("verify.py", fn, set())
    assert [f.rule for f in findings] == ["purity-host-sync"]
    assert "bool()" in findings[0].msg
