"""Voxel-Gaussian map construction and lookup for NDT scan matching.

Port of :mod:`icp_tpu.ops.ndt` (Biber & Strasser 2003, 2D; Magnusson 2009,
3D).  A map holds one Gaussian per occupied cell in a table of ``capacity``
slots:

* **Build** (:func:`build_ndt_map`): one stable sort on the packed int32
  cell keys of :mod:`icp_tpu_torch.ops.grid_nn` per lane, segment ids from
  adjacent-key comparison, then first and second moments per cell by
  ``index_add_`` into the slot table and the keys by a ``scatter_reduce``
  minimum whose identity is the int32-max sentinel.  Every lane of every
  grid is built by the same few ops (no loop over lanes).  Second moments
  are taken relative to each point's cell corner, so they stay accurate far
  from the origin.  Covariance eigenvalues below ``min_eigenvalue_ratio`` of
  the largest are clamped to it, and the inverse is stored.
* **Lookup**: :func:`lookup_cells` by ``searchsorted`` into the sorted key
  table and a gather; :func:`lookup_cells_dense` by an exact-key one-hot
  ``(..., N, V)`` matrix times the packed statistics, one matmul.  Both give
  the same hits, slots and statistics (misses differ: the dense lookup
  returns zeros there).
* **Overlapping grids** (:func:`build_overlapping_ndt_maps`): the ``2^D``
  grids shifted by half a cell per axis combination, stacked on a leading
  axis.

Cell membership is ``floor((p + offset) / cell_size)``.  Cells with fewer
than ``min_points`` members are invalid; overflow beyond ``capacity``
occupied cells sets ``overflowed``.  On the card, ``index_add_`` adds in no
fixed order, so the moments agree with the CPU to float32 rounding, not bit
for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .grid_nn import INT32_MAX, _cell_keys
from .rigid_fit import _jacobi_eigh_sym

DEFAULT_MIN_POINTS = 4
DEFAULT_MIN_EIGENVALUE_RATIO = 1e-2


class NdtMap(NamedTuple):
    """Static-capacity voxel-Gaussian table.

    Slots are in ascending key order; ``valid`` marks well-populated cells.
    Occupied but underpopulated slots keep their real key with identity
    statistics and ``valid=False``; only empty slots carry the int32-max
    sentinel, and those are all trailing.  Every field may carry leading
    batch dims.
    """

    keys: torch.Tensor  # (..., V) int32, ascending; sentinel = int32 max
    means: torch.Tensor  # (..., V, D)
    inv_covs: torch.Tensor  # (..., V, D, D) regularized inverse covariances
    valid: torch.Tensor  # (..., V) bool
    counts: torch.Tensor  # (..., V) member counts (0 on empty slots)
    cell_size: torch.Tensor  # () or (...,) bin side length
    offset: torch.Tensor  # (..., D) grid shift added before binning
    overflowed: torch.Tensor  # (...,) bool: more occupied cells than capacity
    covs: torch.Tensor  # (..., V, D, D) regularized covariances (D2D needs them)


def _sandwich(vecs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``V diag(vals) V^T``."""
    return torch.matmul(vecs * vals[..., None, :], vecs.transpose(-1, -2))


def _regularize_inverse(cov: torch.Tensor, min_ratio: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Clamp eigenvalues to ``min_ratio * lambda_max`` (Magnusson 2009
    §6.2), with an absolute floor of ``sqrt(tiny)``; returns the
    ``(regularized inverse, regularized covariance)``."""
    eigvals, eigvecs = _jacobi_eigh_sym(cov)
    lam_max = eigvals.max(-1, keepdim=True).values
    floor = torch.clamp(min_ratio * lam_max, min=torch.finfo(cov.dtype).tiny ** 0.5)
    lam = torch.maximum(eigvals, floor)
    return _sandwich(eigvecs, 1.0 / lam), _sandwich(eigvecs, lam)


def _segment_sum(values: torch.Tensor, seg: torch.Tensor, slots: int) -> torch.Tensor:
    """Sum ``values (L, N, ...)`` into ``slots`` per lane by ``seg (L, N)``."""
    lanes, n = seg.shape
    flat = values.reshape(lanes * n, -1)
    out = torch.zeros((lanes * slots, flat.shape[-1]), dtype=values.dtype, device=values.device)
    out.index_add_(0, seg.reshape(-1), flat)
    return out.reshape((lanes, slots) + values.shape[2:])


def _build_lanes(points, mask, cell_size, offset, capacity, min_points, min_ratio):
    """The builder on ``points (L, N, D)``, ``mask (L, N)``, ``offset
    (L, D)``: one map per lane, fields ``(L, V, ...)``."""
    lanes, n, dim = points.shape
    dtype, dev = points.dtype, points.device
    off = offset[:, None, :]
    key, _ = _cell_keys(points + off, cell_size, dim)
    key = torch.where(mask, key, INT32_MAX)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    pts_s = torch.take_along_dim(points, order[..., None], dim=-2)
    valid_s = key_s != INT32_MAX

    # Dense segment ids in sorted order; the invalid tail gets weight 0.
    first = torch.ones_like(valid_s)
    first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    seg = torch.cumsum(first, dim=-1) - 1  # (L, N) int64, 0-based
    n_valid = valid_s.sum(-1)
    last = torch.take_along_dim(seg, torch.clamp(n_valid - 1, min=0)[:, None], dim=-1)[:, 0]
    n_cells = torch.where(n_valid > 0, last + 1, 0)
    w = valid_s & (seg < capacity)
    segc = torch.clamp(seg, max=capacity - 1)
    wf = w.to(dtype)
    flat = segc + torch.arange(lanes, device=dev)[:, None] * capacity

    cnt = _segment_sum(wf, flat, capacity)  # (L, V)
    psum = _segment_sum(pts_s * wf[..., None], flat, capacity)
    # Second moments in each point's cell-corner frame: constant within a
    # cell, so the covariance is unchanged, but the products stay on
    # O(cell_size) values and E[pp^T] - mu mu^T does not cancel in float32.
    anchor = torch.floor((pts_s + off) / cell_size) * cell_size - off
    rel = pts_s - anchor
    rsum = _segment_sum(rel * wf[..., None], flat, capacity)
    outer = rel[..., :, None] * rel[..., None, :]
    osum = _segment_sum(outer * wf[..., None, None], flat, capacity)
    keys = torch.full((lanes * capacity,), INT32_MAX, dtype=torch.int32, device=dev)
    keys.scatter_reduce_(0, flat.reshape(-1), torch.where(w, key_s, INT32_MAX).reshape(-1),
                         "amin", include_self=True)
    keys = keys.reshape(lanes, capacity)

    denom = torch.clamp(cnt, min=1.0)
    mean = psum / denom[..., None]
    mean_rel = rsum / denom[..., None]
    cov = osum / denom[..., None, None] - mean_rel[..., :, None] * mean_rel[..., None, :]
    cell_valid = cnt >= min_points
    # Underpopulated cells keep their real key (the table must stay sorted
    # for lookup_cells) and identity statistics, gated by ``valid``.
    eye = torch.eye(dim, dtype=dtype, device=dev)
    gate = cell_valid[..., None, None]
    cov = torch.where(gate, cov, eye)
    inv_cov, reg_cov = _regularize_inverse(cov, min_ratio)
    return NdtMap(
        keys=keys,
        means=torch.where(cell_valid[..., None], mean, 0.0),
        inv_covs=torch.where(gate, inv_cov, eye),
        valid=cell_valid,
        counts=cnt,
        cell_size=torch.full((lanes,), float(cell_size), dtype=dtype, device=dev),
        offset=offset.to(dtype),
        overflowed=n_cells > capacity,
        covs=torch.where(gate, reg_cov, eye),
    )


def _build(points, mask, cell_size, offsets, capacity, min_points, min_ratio) -> NdtMap:
    """Maps of ``points (*lead, N, D)`` under ``offsets (*lead, D)``."""
    lead = points.shape[:-2]
    n, dim = points.shape[-2:]
    flat = _build_lanes(
        points.reshape(-1, n, dim), mask.reshape(-1, n), cell_size,
        offsets.expand(*lead, dim).reshape(-1, dim), capacity, min_points, min_ratio,
    )
    return NdtMap(*(x.reshape(lead + x.shape[1:]) for x in flat))


def build_ndt_map(
    points: torch.Tensor,
    mask: torch.Tensor,
    cell_size,
    capacity: int,
    offset: torch.Tensor | None = None,
    min_points: int = DEFAULT_MIN_POINTS,
    min_eigenvalue_ratio: float = DEFAULT_MIN_EIGENVALUE_RATIO,
) -> NdtMap:
    """Voxel-Gaussian map of ``points (..., N, D)`` with ``mask (..., N)``,
    batched over leading dims; ``capacity`` is the slot budget."""
    dim = points.shape[-1]
    if offset is None:
        offset = torch.zeros((dim,), dtype=points.dtype, device=points.device)
    offset = torch.as_tensor(offset, dtype=points.dtype, device=points.device)
    return _build(points, mask, cell_size, offset, capacity, min_points, min_eigenvalue_ratio)


def build_overlapping_ndt_maps(
    points: torch.Tensor,
    mask: torch.Tensor,
    cell_size,
    capacity: int,
    min_points: int = DEFAULT_MIN_POINTS,
    min_eigenvalue_ratio: float = DEFAULT_MIN_EIGENVALUE_RATIO,
) -> NdtMap:
    """The ``2^D`` half-cell-shifted grids of the original 2D NDT, stacked
    on a new LEADING ``G = 2^D`` axis (maps are indexed ``[g, ..., v]``)."""
    dim = points.shape[-1]
    batch = points.shape[:-2]
    half = torch.tensor(cell_size, dtype=points.dtype, device=points.device) / 2
    bits = torch.tensor([0.0, 1.0], dtype=points.dtype, device=points.device)
    # The 2^D shifts in meshgrid ij order, as the JAX package stacks them.
    offsets = torch.stack(torch.meshgrid(*([bits] * dim), indexing="ij"), -1).reshape(-1, dim)
    offsets = offsets * half
    g = offsets.shape[0]
    offsets = offsets.reshape((g,) + (1,) * len(batch) + (dim,)).expand(g, *batch, dim)
    return _build(
        points.expand(g, *points.shape), mask.expand(g, *mask.shape), cell_size, offsets,
        capacity, min_points, min_eigenvalue_ratio,
    )


def _map_frame(ndt: NdtMap):
    """The map's offset and cell size aligned with a query's point axis."""
    offset, cell = ndt.offset, ndt.cell_size
    if offset.dim() > 1:
        offset = offset[..., None, :]
    if cell.dim() >= 1:
        cell = cell[..., None, None]
    return offset, cell


def lookup_cells_dense(query: torch.Tensor, ndt: NdtMap, include_covs: bool = False):
    """:func:`lookup_cells` as one matmul: the exact-key one-hot ``(..., N,
    V)`` times the packed per-slot statistics ``[1, slot, mean, inv_cov
    (, cov)]``.  Keys are unique per map, so each row has at most one 1 and
    the product reproduces the gathered values exactly (``x * 1.0`` and
    ``+ 0.0`` are exact; TF32 is off); the slot column is exact for
    ``V < 2^24`` in float32.  Misses return zero statistics, ``hit=False``.
    Query and map share their leading dims.
    """
    dim = query.shape[-1]
    v = ndt.keys.shape[-1]
    offset, cell = _map_frame(ndt)
    key, _ = _cell_keys(query + offset, cell, dim)
    eq = (key[..., :, None] == ndt.keys[..., None, :]) & ndt.valid[..., None, :]
    onehot = eq.to(query.dtype)
    head = torch.stack(
        [torch.ones((v,), dtype=query.dtype, device=query.device),
         torch.arange(v, dtype=query.dtype, device=query.device)], -1,
    ).expand(*ndt.means.shape[:-1], 2)
    cols = [head, ndt.means, ndt.inv_covs.flatten(-2)]
    if include_covs:
        cols.append(ndt.covs.flatten(-2))
    sel = torch.matmul(onehot, torch.cat(cols, dim=-1))
    hit = sel[..., 0] > 0.5
    idx = sel[..., 1].to(torch.int32)
    dd = dim * dim
    means = sel[..., 2:2 + dim]
    inv_covs = sel[..., 2 + dim:2 + dim + dd].unflatten(-1, (dim, dim))
    if include_covs:
        return means, inv_covs, hit, idx, sel[..., 2 + dim + dd:].unflatten(-1, (dim, dim))
    return means, inv_covs, hit, idx


def lookup_cells(query: torch.Tensor, ndt: NdtMap, include_covs: bool = False):
    """Cell statistics of the cell containing each query point.

    ``query (..., N, D)`` against an unbatched map, or a map whose leading
    dims equal the query's -> ``(means (..., N, D), inv_covs (..., N, D, D),
    hit (..., N) bool, idx (..., N) int32)``, plus ``covs`` when
    ``include_covs``.  Misses (unoccupied or invalid cells) have
    ``hit=False`` and the statistics of an arbitrary slot.
    """
    dim = query.shape[-1]
    v = ndt.keys.shape[-1]
    offset, cell = _map_frame(ndt)
    key, _ = _cell_keys(query + offset, cell, dim)
    keys = ndt.keys.reshape(-1, v)
    flat = key.reshape(keys.shape[0], -1)
    pos = torch.searchsorted(keys, flat, side="left")
    idx = torch.clamp(pos, max=v - 1)

    def take(field):  # (..., V, *tail) -> (..., N, *tail)
        rows = field.reshape(keys.shape[0], v, -1)
        got = torch.take_along_dim(rows, idx[..., None], dim=-2)
        return got.reshape(key.shape + field.shape[ndt.keys.dim():])

    hit = (torch.take_along_dim(keys, idx, dim=-1) == flat) & torch.take_along_dim(
        ndt.valid.reshape(-1, v), idx, dim=-1)
    out = (take(ndt.means), take(ndt.inv_covs), hit.reshape(key.shape),
           idx.to(torch.int32).reshape(key.shape))
    return out + (take(ndt.covs),) if include_covs else out


def inverse_small_spd(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 2x2 / 3x3 SPD matrices (adjugate /
    det), elementwise."""
    d = m.shape[-1]
    if d == 2:
        a, b = m[..., 0, 0], m[..., 0, 1]
        c, e = m[..., 1, 0], m[..., 1, 1]
        det = a * e - b * c
        adj = torch.stack([torch.stack([e, -b], -1), torch.stack([-c, a], -1)], -2)
        return adj / det[..., None, None]
    if d == 3:
        a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
        e, f, g = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
        h, i, j = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
        ca = f * j - g * i
        cb = g * h - e * j
        cc = e * i - f * h
        det = a * ca + b * cb + c * cc
        adj = torch.stack(
            [
                torch.stack([ca, c * i - b * j, b * g - c * f], -1),
                torch.stack([cb, a * j - c * h, c * e - a * g], -1),
                torch.stack([cc, b * h - a * i, a * f - b * e], -1),
            ],
            -2,
        )
        return adj / det[..., None, None]
    raise ValueError(f"inverse_small_spd supports D in (2, 3), got {d}")
