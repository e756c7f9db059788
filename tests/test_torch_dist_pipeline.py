"""The port's dp x mp step on gloo ranks (parallel/dryrun.py spawns them, one
process per rank, on the CPU) against the JAX step under shard_map on the
conftest's virtual CPU mesh, on the same seeded inputs:

  * 2 x 2: keep (each rank's dp slice), metrics and each rank's filter
    shard, before and after the AgingBloom update, over two steps around
    one rotation; each batch runs twice on the same buffers, and both runs
    give JAX's answer (the pool's resubmit);
  * 4 x 1 and 1 x 2: the dedup half alone, on given verdicts, against the
    port's single-rank dedup and an exact host model of the dedup rules;
  * the dry run at 4 x 2 (8 ranks), the counterpart of the JAX
    dryrun_multichip(8).

The JAX 2 x 2 step is the one JAX mesh compile of this file.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from firedancer_tpu.models import pipeline as PJ
from firedancer_tpu.parallel import dryrun as DJ
from firedancer_tpu_torch.models import pipeline as PT
from firedancer_tpu_torch.ops.ed25519 import hostpath
from firedancer_tpu_torch.parallel import dryrun

B, W = 8, 64
DP, MP = 2, 2


def _batch(seed, sk, pk):
    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (B, W), np.uint8)
    lens = np.full(B, W, np.int32)
    sigs = np.stack([
        np.frombuffer(hostpath.sign(sk, m.tobytes()), np.uint8) for m in msgs
    ])
    pubs = np.tile(np.frombuffer(pk, np.uint8), (B, 1))
    return {"msgs": msgs, "lens": lens, "sigs": sigs, "pubs": pubs}


def _tags(sigs):
    return sigs[:, :8].copy().view(np.uint32).reshape(len(sigs), 2)


@pytest.fixture(scope="module")
def mesh_runs():
    """Two batches through the JAX step on a 2 x 2 mesh and through the
    port's step on 2 x 2 gloo ranks, each batch twice on the same buffers,
    capacity 1 (a rotation after the first update)."""
    rng = np.random.default_rng(7)
    sk = rng.integers(0, 256, 32, np.uint8).tobytes()
    pk = hostpath.public_from_secret(sk)
    b1 = _batch(100, sk, pk)
    b1["msgs"][5], b1["sigs"][5] = b1["msgs"][0], b1["sigs"][0]  # dup across dp
    b1["sigs"][2, 40] ^= 1  # a failed signature...
    b1["tags2"] = _tags(b1["sigs"])
    b1["tags2"][6] = b1["tags2"][2]  # ...whose tag a valid later lane shares
    b2 = _batch(200, sk, pk)
    for k in ("msgs", "sigs"):
        b2[k][[0, 4, 7]] = b1[k][[1, 3, 6]]  # cross-batch repeats of batch 1
    b2["tags2"] = _tags(b2["sigs"])
    batches = [b1, b2]

    mesh = Mesh(np.array(jax.devices()[: DP * MP]).reshape(DP, MP), ("dp", "mp"))
    step_j = PJ.make_step(mesh)
    bloom_j = PJ.AgingBloom(mesh, capacity=1)
    jax_out = []
    for b in batches:
        args = [b[k] for k in ("msgs", "lens", "sigs", "pubs", "tags2")]
        bufs = bloom_j.buffers()
        runs = [step_j(*args, *bufs) for _ in range(2)]
        out = {key: [np.asarray(r[i]) for r in runs]
               for i, key in enumerate(("keep", "cur", "metrics"))}
        bloom_j.update(runs[0][1], runs[0][2])
        out["after"] = (np.asarray(bloom_j.cur), np.asarray(bloom_j.prev),
                        bloom_j.inserted, bloom_j.rotations)
        jax_out.append(out)
    port = dryrun.run_steps(DP, MP, batches, capacity=1, repeat=True, device="cpu")
    return jax_out, port


def _shard(full, m):
    words = full.shape[0] // MP
    return full[m * words : (m + 1) * words]


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("rank", range(DP * MP))
def test_2x2_step_matches_jax(mesh_runs, step, rank):
    jax_out, port = mesh_runs
    j, p = jax_out[step], port[rank][step]
    d, m = divmod(rank, MP)
    bl = B // DP
    for run in range(2):  # the first run and the resubmitted one
        np.testing.assert_array_equal(p["keep"][run], j["keep"][run][d * bl : (d + 1) * bl])
        np.testing.assert_array_equal(p["metrics"][run], j["metrics"][run])
        np.testing.assert_array_equal(p["cur"][run].view(np.uint32),
                                      _shard(j["cur"][run], m))


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("rank", range(DP * MP))
def test_2x2_filter_state_matches_jax(mesh_runs, step, rank):
    jax_out, port = mesh_runs
    cur, prev, inserted, rotations = jax_out[step]["after"]
    p = port[rank][step]
    m = rank % MP
    np.testing.assert_array_equal(p["cur_after"].view(np.uint32), _shard(cur, m))
    np.testing.assert_array_equal(p["prev_after"].view(np.uint32), _shard(prev, m))
    assert (p["inserted"], p["rotations"]) == (inserted, rotations)


def test_2x2_semantics_and_resubmit(mesh_runs):
    jax_out, port = mesh_runs
    # lane 5 repeats lane 0 (another dp rank); lane 2 fails; lane 6 shares
    # its tag and is not a first occurrence
    keep0 = np.concatenate([port[r][0]["keep"][0] for r in (0, 2)])
    assert keep0.tolist() == [True, True, False, True, True, False, False, True]
    assert port[0][0]["metrics"][0].tolist() == [7, 1, 0, 5]
    assert port[0][0]["rotations"] == 1
    # batch 2 lanes 0 and 4 repeat inserted lanes of batch 1 and are
    # remembered across the rotation; lane 7 repeats batch 1's lane 6,
    # whose own tag was never inserted
    keep1 = np.concatenate([port[r][1]["keep"][0] for r in (0, 2)])
    assert keep1.tolist() == [False, True, True, True, False, True, True, True]
    assert port[0][1]["metrics"][0].tolist() == [8, 0, 2, 6]
    # a batch run twice on the same buffers gets the same answer (C-1)
    for r in range(DP * MP):
        for s in range(2):
            for key in ("keep", "metrics", "cur"):
                a, b = port[r][s][key]
                np.testing.assert_array_equal(a, b)


class DedupModel:
    """Exact host model of the step's dedup rules over python sets."""

    def __init__(self, capacity):
        self.cur, self.prev = set(), set()
        self.inserted, self.rotations, self.capacity = 0, 0, capacity

    def step(self, tags2, ok):
        tags = [(int(h) << 32) | int(l) for l, h in tags2]
        seen, keep, m, new = set(), [], [0, 0, 0, 0], []
        for t, good in zip(tags, ok):
            first = t not in seen
            seen.add(t)
            hit = t in self.cur or t in self.prev
            keep.append(bool(good and not hit and first))
            m[0] += int(good)
            m[1] += int(not good)
            m[2] += int(good and hit)
            if good and first:
                new.append(t)
                m[3] += int(not hit)
        self.cur.update(new)
        self.inserted += m[3]
        if self.inserted >= self.capacity:
            self.prev, self.cur = self.cur, set()
            self.inserted = 0
            self.rotations += 1
        return np.array(keep), m


def _dedup_batches(n_lanes, n_batches, seed):
    """Verdicts and tags with within-batch duplicates, failed lanes sharing
    tags with valid ones, and repeats of earlier batches."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        tags2 = rng.integers(0, 1 << 32, (n_lanes, 2), dtype=np.uint64).astype(np.uint32)
        ok = rng.random(n_lanes) > 0.2
        tags2[n_lanes - 4 :] = tags2[:4]  # within-batch duplicates
        if out:
            tags2[4:10] = out[-1]["tags2"][10:16]  # repeats of the last batch
        out.append({"ok": ok, "tags2": tags2})
    return out


@pytest.mark.parametrize("dp,mp", [(4, 1), (1, 2)])
def test_dedup_half_matches_single_rank_and_host_model(dp, mp):
    lanes = 32
    batches = _dedup_batches(lanes, 3, seed=dp * 10 + mp)
    capacity = 40  # rotates after the second batch
    port = dryrun.run_steps(dp, mp, batches, capacity=capacity, device="cpu")
    bloom = PT.AgingBloom("cpu", capacity)
    model = DedupModel(capacity)
    for i, b in enumerate(batches):
        want_keep, want_m = model.step(b["tags2"], b["ok"])
        keep, cur, met = PT.dedup(torch.from_numpy(b["ok"]),
                                  torch.from_numpy(b["tags2"].astype(np.int64)),
                                  *bloom.buffers())
        bloom.update(cur, met)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
        assert met.tolist() == want_m
        got_keep = np.concatenate([port[d * mp][i]["keep"][0] for d in range(dp)])
        np.testing.assert_array_equal(got_keep, want_keep)
        for r in range(dp * mp):
            assert port[r][i]["metrics"][0].tolist() == want_m
            assert port[r][i]["rotations"] == model.rotations == bloom.rotations
        for key, full in (("cur_after", bloom.cur), ("prev_after", bloom.prev)):
            shards = np.concatenate([port[m][i][key] for m in range(mp)])
            np.testing.assert_array_equal(shards, full.numpy())
    assert model.rotations == 1


@pytest.mark.parametrize("n", range(1, 10))
def test_mesh_axes_match_jax(n):
    assert dryrun._mesh_axes(n) == DJ._mesh_axes(n)


def test_dryrun_multichip_4x2(capfd):
    """dp = 4, mp = 2 on 8 gloo ranks: dryrun_step, dryrun_sustained (two
    rotation boundaries, recall and forgetting, an uneven final batch) and
    the pool over two CPU domains; the JAX dry run's rotation count."""
    from firedancer_tpu_torch import entry

    entry.dryrun_multichip(8, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_sustained ok: 6 steps, rotations=6" in out
    assert "dryrun_multichip ok: full pipeline on mesh dp=4 mp=2" in out
