"""Ring exact nearest neighbours: target blocks rotate, memory stays O(M/P).

Port of :mod:`icp_tpu.parallel.ring_nn`.  Both clouds are split over
``points`` and the target is never gathered: each rank folds its query
block against the target block it holds, then passes that block to the next
rank of the ring (``torch.distributed.batch_isend_irecv``, through
:func:`icp_tpu_torch.parallel.comm.ring_shift`) while it folds, so the
transfer overlaps the kernel.  Per-rank memory is O(N/P + M/P).

P ranks need P folds and P - 1 transfers; at world size 1 there is no
transfer at all.  The JAX package did P rotations, the last one wasted, to
stay clear of a JAX/TPU miscompile of ``ppermute`` outputs used after a
``fori_loop`` (its module doc); a Python loop over explicit transfers has
no such hazard.

Exactness: for finite inputs, bit-equal to the kernel on the whole target.
The fold keeps a strictly smaller ``sq``, or an equal ``sq`` with a smaller
global index, starting from ``(inf, INT32_MAX)``; each block's kernel
already returns the block's lowest-index minimum, so the visit order does
not matter.  NaN coordinates are a documented deviation, as in the JAX
package: the fold drops NaN distances (a row with no other candidate
returns +inf / INT32_MAX) where a whole-target argmin would propagate them.  Keep
inputs finite (the cloud layer drops non-finite points).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.fused_nn import fused_nearest_neighbors
from ..ops.pallas_nn import nearest_neighbors_pallas
from .comm import ring_shift
from .mesh import POINT_AXIS, axis_group
from .sharded_nn import check_equal_blocks

INT32_MAX = torch.iinfo(torch.int32).max


def ring_fold(query, targets, target_mask, group, with_points: bool):
    """The ring over ``group``: ``(sq, global_idx[, matched_points])`` of
    this rank's query block against every rank's target block.

    The block and its mask travel as one tensor (the mask as a last
    coordinate column of 0/1), one transfer per step.
    """
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    shard_m, dim = targets.shape
    n_local = query.shape[0]
    best_sq = torch.full((n_local,), torch.inf, dtype=query.dtype, device=query.device)
    best_idx = torch.full((n_local,), INT32_MAX, dtype=torch.int32, device=query.device)
    best_pt = torch.zeros_like(query) if with_points else None
    block = torch.cat([targets, target_mask.to(targets.dtype)[:, None]], dim=1)
    for step in range(size):
        pending = ring_shift(block, group) if step < size - 1 else None
        pts = block[:, :dim].contiguous()
        mask = block[:, dim] > 0
        if with_points:
            sq, idx, coords = fused_nearest_neighbors(query, pts, mask, return_coords=True)
        else:
            sq, idx = nearest_neighbors_pallas(query, pts, mask)
        owner = (rank - step) % size
        gidx = idx + owner * shard_m
        better = (sq < best_sq) | ((sq == best_sq) & (gidx < best_idx))
        best_sq = torch.where(better, sq, best_sq)
        best_idx = torch.where(better, gidx, best_idx)
        if with_points:
            best_pt = torch.where(better[:, None], coords, best_pt)
        if pending is not None:
            block = pending.wait()
    if with_points:
        return best_sq, best_idx, best_pt
    return best_sq, best_idx


def ring_nearest_neighbors(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None,
    mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact 1-NN with BOTH clouds split over ``points``.

    ``query (n, D)``, ``targets (m, D)`` and ``target_mask (m,)`` are this
    rank's blocks (the global N and M must divide the axis size).  Returns
    ``(sq (n,), indices (n,) int32)`` for this rank's queries, over the whole
    target: the values of the kernel on the whole target (finite inputs).
    """
    group = axis_group(mesh, POINT_AXIS)
    check_equal_blocks(group, query.shape[0], targets.shape[0])
    if target_mask is None:
        target_mask = torch.ones((targets.shape[0],), dtype=torch.bool, device=targets.device)
    return ring_fold(query, targets, target_mask, group, with_points=False)


def ring_nn_with_points(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor,
    mesh,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`ring_nearest_neighbors` with the matched target COORDINATES as
    well (the K1 wrapper per block), for callers that fit on the matches
    while the target stays split.  Returns ``(sq (n,), global_idx (n,)
    int32, matched (n, D))``."""
    group = axis_group(mesh, POINT_AXIS)
    check_equal_blocks(group, query.shape[0], targets.shape[0])
    return ring_fold(query, targets, target_mask, group, with_points=True)
