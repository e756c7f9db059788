"""The port's single-card ingress step against the JAX step on a 1x1 CPU
mesh, at the real BLOOM_BITS = 2^28, from the same filter state (carried
across with AgingBloom.from_numpy): two steps around one rotation, with
within-batch duplicates, a failed signature sharing a tag with a valid one,
and cross-batch repeats.  keep, metrics and every filter word must be equal.
Also select_noconflict against the host greedy oracle of tests/test_pack.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from firedancer_tpu.models import pipeline as PJ
from firedancer_tpu_torch.models import pipeline as PT
from firedancer_tpu_torch.ops import pack_select
from firedancer_tpu_torch.ops.ed25519 import hostpath

B, W = 8, 64


def _batch(seed, sk, pk):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (B, W), np.uint8)
    lens = np.full(B, W, np.int32)
    sigs = np.stack([
        np.frombuffer(hostpath.sign(sk, m.tobytes()), np.uint8) for m in msgs
    ])
    pubs = np.tile(np.frombuffer(pk, np.uint8), (B, 1))
    return msgs, lens, sigs, pubs


def _tags(sigs):
    return sigs[:, :8].copy().view(np.uint32).reshape(len(sigs), 2)


@pytest.fixture(scope="module")
def runs():
    """Both steps over the same two batches; -> per step (jax, port)
    outputs and filter states."""
    rng = np.random.default_rng(7)
    sk = rng.integers(0, 256, 32, np.uint8).tobytes()
    pk = hostpath.public_from_secret(sk)
    m1, l1, s1, p1 = _batch(100, sk, pk)
    m1[1], s1[1] = m1[0], s1[0]  # within-batch duplicate of lane 0
    s1[5, 40] ^= 1  # failed signature...
    t1 = _tags(s1)
    t1[6] = t1[5]  # ...whose tag a valid later lane shares
    m2, l2, s2, p2 = _batch(200, sk, pk)
    m2[:3], s2[:3] = m1[:3], s1[:3]  # cross-batch repeats of batch 1
    t2 = _tags(s2)
    batches = [(m1, l1, s1, p1, t1), (m2, l2, s2, p2, t2)]

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "mp"))
    step_j = PJ.make_step(mesh)
    bloom_j = PJ.AgingBloom(mesh, capacity=1)  # rotate after the first step
    step_t = PT.make_step("cpu")
    bloom_t = PT.AgingBloom.from_numpy(
        np.asarray(bloom_j.cur), np.asarray(bloom_j.prev),
        bloom_j.inserted, bloom_j.rotations, device="cpu", capacity=1,
    )
    out = []
    for b in batches:
        keep_j, cur_j, met_j = step_j(*b, *bloom_j.buffers())
        keep_t, cur_t, met_t = step_t(*b, *bloom_t.buffers())
        step_out = {
            "keep": (np.asarray(keep_j), keep_t.numpy()),
            "metrics": (np.asarray(met_j), met_t.numpy()),
            "cur": (np.asarray(cur_j), cur_t.numpy().view(np.uint32).copy()),
        }
        bloom_j.update(cur_j, met_j)
        bloom_t.update(cur_t, met_t)
        cur, prev, ins, rot = bloom_t.to_numpy()
        step_out["state"] = (
            (np.asarray(bloom_j.cur), np.asarray(bloom_j.prev),
             bloom_j.inserted, bloom_j.rotations),
            (cur.copy(), prev.copy(), ins, rot),
        )
        out.append(step_out)
    return out


@pytest.mark.parametrize("step", [0, 1])
def test_step_matches_jax(runs, step):
    r = runs[step]
    for key in ("keep", "metrics", "cur"):
        want, got = r[key]
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("step", [0, 1])
def test_filter_state_matches_jax(runs, step):
    (cj, pj, ij, rj), (ct, pt, it, rt) = runs[step]["state"]
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(pt, pj)
    assert (it, rt) == (ij, rj)


def test_step_semantics(runs):
    keep0, _ = runs[0]["keep"]
    met0, _ = runs[0]["metrics"]
    # lane 1 repeats lane 0; lane 5 fails; lane 6 shares lane 5's tag
    assert keep0.tolist() == [True, False, True, True, True, False, False, True]
    assert met0.tolist() == [7, 1, 0, 5]
    assert runs[0]["state"][1][3] == 1  # rotated after step 0
    keep1, _ = runs[1]["keep"]
    met1, _ = runs[1]["metrics"]
    # lanes 0-2 repeat batch 1 and are remembered across the rotation
    assert keep1.tolist()[:3] == [False] * 3 and all(keep1[3:])
    assert met1.tolist()[2] >= 2


def test_tag_bits_match_jax():
    rng = np.random.default_rng(3)
    tags = rng.integers(0, 1 << 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    tags[0] = [0xFFFFFFFF, 0xFFFFFFFF]
    got = PT._tag_bits(torch.from_numpy(tags.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(PJ._tag_bits(jnp.asarray(tags))))


def test_aging_bloom_roundtrip():
    rng = np.random.default_rng(5)
    cur = rng.integers(0, 1 << 32, PT.BLOOM_BITS // 32, dtype=np.uint64)
    cur = cur.astype(np.uint32)
    prev = cur[::-1].copy()
    b = PT.AgingBloom.from_numpy(cur, prev, 17, 2, device="cpu")
    c2, p2, ins, rot = b.to_numpy()
    np.testing.assert_array_equal(c2, cur)
    np.testing.assert_array_equal(p2, prev)
    assert (ins, rot) == (17, 2)


def _host_greedy(cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit,
                 txn_limit):
    """The host-side oracle of tests/test_pack.py: same greedy rules."""
    sel_rw, sel_w = in_use_rw.copy(), in_use_w.copy()
    cu, taken = 0, 0
    want = np.zeros(len(costs), dtype=bool)
    for i in range(len(costs)):
        c = int(costs[i])
        if cu + c > cu_limit or taken >= txn_limit:
            continue
        if (cand_w[i] & sel_rw).any() or (cand_rw[i] & sel_w).any():
            continue
        want[i] = True
        sel_rw |= cand_rw[i]
        sel_w |= cand_w[i]
        cu += c
        taken += 1
    return want


@pytest.mark.parametrize("trial", range(3))
def test_select_noconflict_matches_host_greedy(trial):
    rng = np.random.default_rng(23 + trial)
    K, Wd = 64, 4
    cand_rw = np.zeros((K, Wd), dtype=np.uint64)
    cand_w = np.zeros((K, Wd), dtype=np.uint64)
    for i in range(K):
        for b in rng.integers(0, Wd * 64, 4):
            cand_rw[i, b >> 6] |= np.uint64(1) << np.uint64(b & 63)
        for b in rng.integers(0, Wd * 64, 2):
            cand_w[i, b >> 6] |= np.uint64(1) << np.uint64(b & 63)
    cand_rw |= cand_w
    in_use_rw = np.zeros(Wd, dtype=np.uint64)
    in_use_w = np.zeros(Wd, dtype=np.uint64)
    for b in rng.integers(0, Wd * 64, 8):
        in_use_rw[b >> 6] |= np.uint64(1) << np.uint64(b & 63)
    costs = rng.integers(1000, 500_000, K).astype(np.int64)
    costs[-1] = pack_select.PAD_COST  # a padding row is never taken
    cu_limit = int(costs[:-1].sum() // 3)
    args = (cand_rw, cand_w, in_use_rw, in_use_w, costs, cu_limit, 16)
    got = pack_select.select_noconflict(*args, device="cpu")
    np.testing.assert_array_equal(got, _host_greedy(*args))
    assert got.any() and not got[-1]
    dev_in = [torch.from_numpy(pack_select.split_u32(a))
              for a in (cand_rw, cand_w, in_use_rw, in_use_w)]
    take = PT.pack_prefilter(*dev_in, torch.from_numpy(costs), cu_limit, 16)
    np.testing.assert_array_equal(take.numpy(), got)


def test_cu_limit_above_max_raises():
    z = np.zeros((2, 1), np.uint64)
    with pytest.raises(ValueError, match="CU_LIMIT_MAX"):
        pack_select.select_noconflict(
            z, z, z[0], z[0], np.zeros(2), pack_select.CU_LIMIT_MAX + 1, 2,
            device="cpu")
