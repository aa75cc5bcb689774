"""Grid-accelerated exact radius-gated 1-NN, and the packed cell keys.

Port of :mod:`icp_tpu.ops.grid_nn`.  Targets are binned into cubic cells of
side ``cell_size`` under packed int32 keys (15 bits per axis in 2D, 10 in
3D) and sorted by key with their original indices (:func:`build_grid`).  A
query visits its ``3^D`` neighbour cells; each cell's members are a
contiguous range of the sorted arrays, found by two ``searchsorted`` calls,
and up to ``cell_capacity`` of them are gathered
(:func:`grid_nearest_neighbors`).  Distances use the per-coordinate
arithmetic of :func:`icp_tpu_torch.ops.nn.pairwise_sq_dists` and ties go to
the lowest original index, so a query whose nearest valid target lies
within ``cell_size`` gets the brute-force answer bit for bit; a query with
nothing inside the radius gets ``(+inf, 0)``.  If a visited cell holds more
than ``cell_capacity`` targets, ``overflowed`` is set.

No method uses the query; :mod:`icp_tpu_torch.ops.ndt` uses
:func:`_cell_keys`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_BITS = {2: 15, 3: 10}
INT32_MAX = torch.iinfo(torch.int32).max


class GridIndex(NamedTuple):
    """Sorted cell-key index over one target cloud."""

    sorted_keys: torch.Tensor  # (M,) int32, masked-out targets last
    sorted_points: torch.Tensor  # (M, D) reordered targets
    sorted_index: torch.Tensor  # (M,) int32 original target indices
    cell_size: torch.Tensor  # () the bin side length


def _cells(points: torch.Tensor, cell_size, bits: int) -> torch.Tensor:
    """Per-axis cell coordinates in ``[0, 2^bits)``: floor, then clip.

    The clip runs on the floats, before the integer conversion, so a point
    beyond the int32 range lands on the border cell as well.
    """
    bound = 1 << (bits - 1)
    cells = torch.clamp(torch.floor(points / cell_size), -bound, bound - 1)
    return cells.to(torch.int32) + bound


def _pack(cells: torch.Tensor, bits: int) -> torch.Tensor:
    key = cells[..., 0]
    for d in range(1, cells.shape[-1]):
        key = (key << bits) | cells[..., d]
    return key


def _cell_keys(points: torch.Tensor, cell_size, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int32 cell key per point, and the per-axis cell coordinates."""
    cells = _cells(points, cell_size, _BITS[dim])
    return _pack(cells, _BITS[dim]), cells


def build_grid(targets: torch.Tensor, target_mask: torch.Tensor | None, cell_size) -> GridIndex:
    """Index ``targets (M, D)`` for :func:`grid_nearest_neighbors` (one
    stable sort); masked-out targets get the int32-max key and sort last."""
    dim = targets.shape[-1]
    key, _ = _cell_keys(targets, cell_size, dim)
    if target_mask is not None:
        key = torch.where(target_mask, key, INT32_MAX)
    order = torch.argsort(key, stable=True)
    return GridIndex(
        sorted_keys=key[order],
        sorted_points=targets[order],
        sorted_index=order.to(torch.int32),
        cell_size=torch.as_tensor(cell_size, dtype=targets.dtype, device=targets.device),
    )


def grid_nearest_neighbors(
    query: torch.Tensor, grid: GridIndex, cell_capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact 1-NN within ``grid.cell_size`` of each query ``(N, D)``.

    Returns ``(sq (N,), idx (N,) int32, overflowed ())``.
    """
    n, dim = query.shape
    m = grid.sorted_points.shape[0]
    bits = _BITS[dim]
    dev = query.device
    cells = _cells(query, grid.cell_size, bits)
    grids = torch.meshgrid(*([torch.arange(-1, 2, device=dev)] * dim), indexing="ij")
    offsets = torch.stack(grids, -1).reshape(-1, dim).to(torch.int32)  # (3^D, D)
    nbr = torch.clamp(cells[:, None, :] + offsets[None], 0, (1 << bits) - 1)
    nbr_key = _pack(nbr, bits).reshape(-1)  # (N * 3^D,)

    start = torch.searchsorted(grid.sorted_keys, nbr_key, side="left").to(torch.int32)
    end = torch.searchsorted(grid.sorted_keys, nbr_key, side="right").to(torch.int32)
    k = offsets.shape[0]
    start, end = start.reshape(n, k), end.reshape(n, k)
    # A border-clamped query can see one cell through several offsets;
    # duplicated candidates are harmless for an argmin.
    overflowed = torch.any(end - start > cell_capacity)

    cand = start[..., None] + torch.arange(cell_capacity, dtype=torch.int32, device=dev)
    valid = (cand < end[..., None]).reshape(n, -1)
    cand = torch.clamp(cand, max=m - 1).reshape(n, -1).long()  # (N, K*C)
    pts = grid.sorted_points[cand]  # (N, K*C, D)
    idx = grid.sorted_index[cand]

    acc = None
    for d in range(dim):
        diff = query[:, None, d] - pts[..., d]
        sq = diff * diff
        acc = sq if acc is None else acc + sq
    inf = torch.tensor(float("inf"), dtype=acc.dtype, device=dev)
    d2 = torch.where(valid, acc, inf)
    sq_min = d2.min(-1).values
    idx_min = torch.where(d2 == sq_min[:, None], idx, INT32_MAX).min(-1).values

    # Certified only inside the radius.
    inside = sq_min <= grid.cell_size * grid.cell_size
    return (torch.where(inside, sq_min, inf),
            torch.where(inside, idx_min, 0).to(torch.int32), overflowed)
