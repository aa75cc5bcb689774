"""Exact nearest neighbours with the target cloud split over ``points``.

Port of :mod:`icp_tpu.parallel.sharded_nn`.  Every rank of the points group
holds a contiguous block of the **target** (rank ``r`` rows ``r·m`` to
``(r+1)·m``), runs the 1-NN kernel's K2 wrapper
(:func:`icp_tpu_torch.ops.pallas_nn.nearest_neighbors_pallas`) on it, and
the per-block ``(sq, index)`` partials are gathered and merged.

The collective per query row is one ``(sq, index)`` pair per rank, small
next to the O(M/P) distance work.  Ties go to the lower *global* target
index, as on one device: each block's kernel returns its lowest-index
minimum, the gather stacks the blocks in rank order (ascending global
index), and a first-occurrence minimum over the stack
(:func:`icp_tpu_torch.ops.nn.masked_min_with_index`) keeps the earliest
block.  So the result is bit-equal to the kernel on the whole target.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.nn import masked_min_with_index
from ..ops.pallas_nn import nearest_neighbors_pallas
from .comm import all_gather
from .mesh import POINT_AXIS, axis_group


def check_equal_blocks(group, *sizes: int) -> None:
    """Raise on every rank unless every rank's block sizes are equal (the
    global capacities divide the points axis); one small gather."""
    mine = torch.tensor(sizes, dtype=torch.int64)
    if dist.get_backend(group) == "nccl":
        mine = mine.cuda()
    every = all_gather(mine[None], group).cpu()
    if not bool((every == every[0]).all()):
        raise ValueError("point capacities must divide the points axis size "
                         f"(blocks per rank: {every.tolist()})")


def sharded_nearest_neighbors(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None,
    mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN with the target split over the ``points`` axis.

    ``query (N, D)`` is whole on every rank; ``targets (m, D)`` and
    ``target_mask (m,)`` are this rank's block of the ``(M, D)`` target
    (``local_block(t, Layout(mesh, (POINT_AXIS,)))``).  Returns
    ``(sq (N,), indices (N,) int32)`` over the whole target, equal on every
    rank and to :func:`~icp_tpu_torch.ops.pallas_nn.nearest_neighbors_pallas`
    on the whole target.
    """
    group = axis_group(mesh, POINT_AXIS)
    shard_m = targets.shape[0]
    check_equal_blocks(group, shard_m)
    if target_mask is None:
        target_mask = torch.ones((shard_m,), dtype=torch.bool, device=targets.device)
    sq, idx = nearest_neighbors_pallas(query, targets, target_mask)
    gidx = idx + dist.get_rank(group) * shard_m
    sq_all = all_gather(sq[None], group)  # (P, N), rank order = ascending index
    idx_all = all_gather(gidx[None], group)
    return masked_min_with_index(sq_all, idx_all, axis=0)
