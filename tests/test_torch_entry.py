"""The port's integration points on the CPU: entry() against the JAX
package's __graft_entry__.entry() (the same seeded example inputs, the
port's verdicts against the golden oracle), local_device_count against the
JAX package's on a host without a card, the configure device stage, and
the bench's JSON line at a tiny batch."""

import json

import numpy as np
import pytest
import torch

import __graft_entry__ as GJ
from firedancer_tpu.app import configure as CJ
from firedancer_tpu_torch import bench, entry
from firedancer_tpu_torch.app import configure
from firedancer_tpu_torch.ops.ed25519 import golden
from firedancer_tpu_torch.utils import devices


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")


def test_entry_matches_graft_entry_inputs_and_golden():
    fn, args = entry.entry(device="cpu")
    _, want_args = GJ.entry()
    assert len(args) == len(want_args) == 4
    for a, b in zip(args, want_args):
        np.testing.assert_array_equal(a, b)
    msgs, lens, sigs, pubs = (a[:6] for a in args)
    got = fn(msgs, lens, sigs, pubs)
    assert got.shape == (6,) and got.dtype == torch.bool
    want = [golden.verify(msgs[i, : lens[i]].tobytes(), sigs[i].tobytes(),
                          pubs[i].tobytes()) == 0 for i in range(6)]
    assert got.tolist() == want


def test_local_device_count_without_card(no_card):
    assert devices.local_device_count() == 1
    assert devices.local_device_count(default=3) == 3


def test_configure_device_stage_reports_without_card(no_card):
    r = configure.stage_device()
    assert isinstance(r, configure.StageResult) and r.name == "device"
    assert not r.ok
    assert "cuda: 0 device(s)" in r.detail and "sm_90a card: no" in r.detail
    assert "kernel cache" in r.detail
    # the JAX stage it stands beside has the same result type and name
    assert CJ._stage_device(False).name == r.name


def test_configure_stage_never_raises(monkeypatch):
    def broken():
        raise OSError("device node gone")

    monkeypatch.setattr(torch.cuda, "device_count", broken)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    r = configure.stage_device()
    assert not r.ok and "device node gone" in r.detail


def test_bench_prints_one_json_line_on_cpu(capsys):
    assert bench.main(["--lanes", "4", "--msg-len", "64", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    for key in ("metric", "value", "unit", "n_devices", "per_device"):
        assert key in out
    # a CPU run never carries a device metric's name
    assert out["metric"] == "ed25519_verifies_per_s_cpu"
    assert out["unit"] == "verify/s" and out["n_devices"] == 1
    assert out["value"] > 0 and out["per_device"] == [out["value"]]
    assert out["digest_form"]["value"] > 0 and out["lanes"] == 4


def test_bench_inputs_verify():
    msgs, lens, sigs, pubs, digests = bench.make_inputs(np.random.default_rng(1), 3, 40)
    for i in range(3):
        assert golden.verify(msgs[i].tobytes(), sigs[i].tobytes(), pubs[i].tobytes()) == 0
