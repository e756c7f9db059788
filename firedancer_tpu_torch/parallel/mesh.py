"""dp x mp process groups over torch.distributed.

The counterpart of the JAX package's 2-axis device mesh
(`Mesh(devices.reshape(dp, mp), ("dp", "mp"))`, firedancer_tpu/parallel/
dryrun.py): rank r sits at (r // mp, r % mp), the same row-major layout.

  dp  data parallel: each dp rank verifies its slice of the batch;
  mp  state parallel: each mp rank owns 1/mp of every dedup filter buffer.

The caller initialises the default process group first (NCCL on cards,
gloo on the CPU; the address, world size and rank are the caller's).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in a dp x mp mesh and its two groups: group_dp
    holds the dp ranks that share its mp index (the all_gather of tags and
    verdicts, the psum of metrics), group_mp the mp ranks that share its dp
    index (the psum of probe bits)."""

    dp: int
    mp: int
    dp_index: int
    mp_index: int
    group_dp: object
    group_mp: object


def init_mesh(dp: int, mp: int) -> ProcessMesh:
    """Build this rank's groups in a default group of dp * mp ranks.

    Every rank creates every group, in the same order, as
    torch.distributed.new_group requires; a group's ranks are listed in
    axis order, so group rank i is axis index i."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp * mp:
        raise ValueError(f"world size {world} != dp {dp} x mp {mp}")
    group_dp = group_mp = None
    for m in range(mp):
        g = dist.new_group([d * mp + m for d in range(dp)])
        if rank % mp == m:
            group_dp = g
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            group_mp = g
    return ProcessMesh(dp, mp, rank // mp, rank % mp, group_dp, group_mp)
