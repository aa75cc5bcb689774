"""NDT scan matching (Biber & Strasser 2003; Magnusson 2009).

Port of :mod:`icp_tpu.methods.ndt`.  The target is voxelized into per-cell
Gaussians once (:mod:`icp_tpu_torch.ops.ndt`), and the source is registered
by maximizing the likelihood of the moved points under them:

    score(T) = sum_i exp(-0.5 (T a_i - mu_c(i))^T Sigma_c(i)^-1 (T a_i - mu_c(i)))

There is no nearest-neighbour search: correspondence is an exact cell-key
lookup, ``dense`` (one-hot matmul, the default) or ``sorted``
(searchsorted and gather), which return the same hits and statistics.

* ``precompute``/``init`` build the ``2^D`` half-cell-shifted grids
  (``overlap=0``: one grid).  The grid axis G sits after any batch dims.
* Each iteration takes one Gauss-Newton step on the twist with the
  Gaussian score as IRLS weight (the positive-definite part of Magnusson's
  Newton Hessian), solved by ``torch.linalg.solve_ex``, then the per-lane
  {full, half, zero} line search of :mod:`icp_tpu_torch.methods.gicp`.
* ``variant="d2d"`` (Stoyanov et al. 2012): the source is voxelized too
  (grid 0) and its Gaussians register against the target's under the
  combined covariance ``R Sigma_s R^T + Sigma_t``.

Per-point cost is the score deficit averaged over grids, ``mean_g (1 -
exp(-0.5 mahal))``, 1 for a point in no valid cell; the driver's cost is
its ``sqrt(mean)`` over valid points (D2D: over valid source cells).

Config: ``cell_size`` (default 1.0), ``cells`` (slot capacity, default
256), ``overlap`` (default 1), ``min_points`` (default 4),
``min_eigenvalue_ratio`` (default 1e-2), ``line_search`` (default 1),
``lookup`` (``"dense"`` or ``"sorted"``), ``variant`` (``"p2d"`` or
``"d2d"``), ``dim``.  Overflow of the map's capacity is recorded in
``state.maps.overflowed``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry, lie
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.ndt import (
    NdtMap,
    build_ndt_map,
    build_overlapping_ndt_maps,
    inverse_small_spd,
    lookup_cells,
    lookup_cells_dense,
)
from .base import Method, masked_rms
from .gicp import _jacobian_rows, line_search, mahalanobis
from .point_to_plane import damped_solve

DEFAULT_CELL_SIZE = 1.0
DEFAULT_CELLS = 256
DEFAULT_MIN_POINTS = 4
DEFAULT_MIN_EIG_RATIO = 1e-2


@dataclasses.dataclass(frozen=True)
class NdtState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    maps: NdtMap  # batch dims, then the G (grid) axis, then V slots
    match_cost: torch.Tensor  # (..., N) mean-over-grids score deficit in [0, 1]


@dataclasses.dataclass(frozen=True)
class NdtD2dState:
    """The distribution-to-distribution variant: the moving set is the
    source map's Gaussians."""

    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    maps: NdtMap  # target maps: batch dims, then G, then V slots
    src_map: NdtMap  # source map, grid 0 only: batch dims, then V slots
    match_cost: torch.Tensor  # (..., V) mean-over-grids deficit per source cell


def _gn_step(jac, icov, resid, w):
    """Twist of one Gauss-Newton step over all grids: ``jac (..., N, D,
    dof)``, ``icov (..., G, N, D, D)``, ``resid (..., G, N, D)``, ``w (...,
    G, N)``.  The grids fold into ``A_n = sum_g w_gn icov_gn`` first."""
    a = (icov * w[..., None, None]).sum(-4)  # (..., N, D, D)
    b = (torch.matmul(icov, resid[..., None])[..., 0] * w[..., None]).sum(-3)  # (..., N, D)
    jt = jac.flatten(-3, -2).transpose(-1, -2)  # (..., dof, N*D)
    jtj = torch.matmul(jt, torch.matmul(a, jac).flatten(-3, -2))
    jtr = torch.matmul(jt, b.flatten(-2)[..., None])[..., 0]
    return damped_solve(jtj, jtr)


def create(config: Config) -> Method:
    cell_size = float(config.get("cell_size", DEFAULT_CELL_SIZE))
    cells = int(config.get("cells", DEFAULT_CELLS))
    overlap = bool(config.get("overlap", 1))
    min_points = int(config.get("min_points", DEFAULT_MIN_POINTS))
    min_ratio = float(config.get("min_eigenvalue_ratio", DEFAULT_MIN_EIG_RATIO))
    use_line_search = bool(config.get("line_search", 1))
    lookup = str(config.get("lookup", "dense"))
    if lookup not in ("dense", "sorted"):
        raise ValueError(f"ndt lookup must be 'dense' or 'sorted', got {lookup!r}")
    variant = str(config.get("variant", "p2d"))
    if variant not in ("p2d", "d2d"):
        raise ValueError(f"ndt variant must be 'p2d' or 'd2d', got {variant!r}")
    dim = int(config.get("dim", 2))
    find = lookup_cells_dense if lookup == "dense" else lookup_cells

    def precompute(cloud: PointCloud) -> NdtMap:
        """The voxel-Gaussian map(s) of a (batched) cloud, the grid axis G
        after the batch dims (only the target's are consumed by p2d)."""
        nb = len(cloud.batch_shape)
        if overlap:
            maps = build_overlapping_ndt_maps(
                cloud.points, cloud.mask, cell_size, cells,
                min_points=min_points, min_eigenvalue_ratio=min_ratio)
        else:
            single = build_ndt_map(cloud.points, cloud.mask, cell_size, cells,
                                   min_points=min_points, min_eigenvalue_ratio=min_ratio)
            maps = NdtMap(*(x[None] for x in single))
        return NdtMap(*(x.movedim(0, nb) for x in maps)) if nb else maps

    def _over_grids(points: torch.Tensor, n_grids: int) -> torch.Tensor:
        """``(..., N, D) -> (..., G, N, D)``, a broadcast view."""
        return points[..., None, :, :].expand(*points.shape[:-2], n_grids, *points.shape[-2:])

    def _lookup_grids(a_cur: torch.Tensor, maps: NdtMap):
        """All grids in one lookup: ``(resid, inv_cov, hit as dtype)``
        shaped ``(..., G, N, ...)``."""
        q = _over_grids(a_cur, maps.keys.shape[-2])
        means, inv_covs, hit, _ = find(q, maps)
        return q - means, inv_covs, hit.to(a_cur.dtype)

    def _deficit_of(resid, icov, hit):
        """Mean-over-grids score deficit ``(..., N)`` in [0, 1]."""
        deficit = torch.where(hit > 0, 1.0 - torch.exp(-0.5 * mahalanobis(resid, icov)), 1.0)
        return deficit.mean(-2)

    def _init_with(source, target, guess, maps) -> NdtState:
        deficit = _deficit_of(*_lookup_grids(geometry.apply(guess, source.points), maps))
        cost = deficit.masked_fill(~source.mask, float("inf"))
        return NdtState(guess, source, target, maps, cost)

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> NdtState:
        return _init_with(source, target, guess, precompute(target))

    def _step(state, moving, valid, stats):
        """The Gauss-Newton step and line search shared by p2d and d2d:
        ``moving (..., N, D)`` the moved points or cell means, ``valid`` their
        weights, ``stats(transform) -> (resid, icov, hit)``."""
        resid, icov, hit = stats(state.transform)
        w = valid[..., None, :] * hit * torch.exp(-0.5 * mahalanobis(resid, icov))
        xi = _gn_step(_jacobian_rows(moving, dim), icov, resid, w)
        n_valid = torch.clamp(valid.sum(-1), min=1.0)

        def post_cost(transform):
            deficit = _deficit_of(*stats(transform)) * valid
            return deficit, deficit.sum(-1) / n_valid

        if use_line_search:
            return line_search(state.transform, xi, dim, post_cost)
        new_transform = geometry.compose(lie.exp(xi, dim), state.transform)
        return new_transform, post_cost(new_transform)[0]

    def iterate(state: NdtState) -> NdtState:
        src = state.source
        new_transform, deficit = _step(
            state, geometry.apply(state.transform, src.points), src.mask.to(src.dtype),
            lambda t: _lookup_grids(geometry.apply(t, src.points), state.maps))
        return dataclasses.replace(state, transform=new_transform,
                                   match_cost=deficit.masked_fill(~src.mask, float("inf")))

    def cost(state: NdtState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    def with_precomputed(maps_a, maps_b) -> Method:
        # Only the target's maps take part in the objective.
        return Method(name="ndt", dim=dim, init=lambda s, t, g: _init_with(s, t, g, maps_b),
                      iterate=iterate, cost=cost, precompute=precompute)

    # ---- D2D (Stoyanov et al. 2012): Gaussians against Gaussians ----

    def _src_grid0(maps_src: NdtMap, nb: int) -> NdtMap:
        """Grid 0 of the source maps: D2D moves one Gaussian set."""
        return NdtMap(*(x.select(nb, 0) for x in maps_src))

    def _d2d_stats(transform, src_map: NdtMap, maps: NdtMap):
        """``(resid, inverse combined covariance, hit)`` over ``(..., G, V)``.
        The combined covariance ``R Sigma_s R^T + Sigma_t`` is recomputed
        from the current rotation at every evaluation (its derivative is
        left out of the step, the standard D2D approximation); a miss has
        ``Sigma_t = 0`` and the hit mask zeroes its term."""
        a_cur = geometry.apply(transform, src_map.means)
        r = transform.rotation[..., None, :, :]
        rot_cov = torch.matmul(torch.matmul(r, src_map.covs), r.transpose(-1, -2))
        q = _over_grids(a_cur, maps.keys.shape[-2])
        means_t, _, hit, _, covs_t = find(q, maps, include_covs=True)
        icov = inverse_small_spd(rot_cov[..., None, :, :, :] + covs_t)
        return q - means_t, icov, hit.to(a_cur.dtype)

    def _init_d2d_with(source, target, guess, maps_t, src_map) -> NdtD2dState:
        deficit = _deficit_of(*_d2d_stats(guess, src_map, maps_t))
        return NdtD2dState(guess, source, target, maps_t, src_map,
                           deficit.masked_fill(~src_map.valid, float("inf")))

    def init_d2d(source, target, guess) -> NdtD2dState:
        nb = len(source.batch_shape)
        return _init_d2d_with(source, target, guess, precompute(target),
                              _src_grid0(precompute(source), nb))

    def iterate_d2d(state: NdtD2dState) -> NdtD2dState:
        src_map = state.src_map
        new_transform, deficit = _step(
            state, geometry.apply(state.transform, src_map.means),
            src_map.valid.to(src_map.means.dtype),
            lambda t: _d2d_stats(t, src_map, state.maps))
        return dataclasses.replace(state, transform=new_transform,
                                   match_cost=deficit.masked_fill(~src_map.valid, float("inf")))

    def cost_d2d(state: NdtD2dState) -> torch.Tensor:
        valid = state.src_map.valid
        finite = state.match_cost.masked_fill(~valid, 0.0)
        n = torch.clamp(valid.sum(-1).to(finite.dtype), min=1.0)
        return torch.sqrt(finite.sum(-1) / n)

    def with_precomputed_d2d(maps_a, maps_b) -> Method:
        # D2D consumes both sides' maps (source grid 0, target grids).
        if maps_a is None:
            raise ValueError("ndt d2d needs the source's precomputed maps")

        def init_pre(s, t, g):
            return _init_d2d_with(s, t, g, maps_b, _src_grid0(maps_a, len(s.batch_shape)))

        return Method(name="ndt", dim=dim, init=init_pre, iterate=iterate_d2d, cost=cost_d2d,
                      precompute=precompute)

    if variant == "d2d":
        return Method(name="ndt", dim=dim, init=init_d2d, iterate=iterate_d2d, cost=cost_d2d,
                      precompute=precompute, with_precomputed=with_precomputed_d2d)
    return Method(
        name="ndt", dim=dim, init=init, iterate=iterate, cost=cost, precompute=precompute,
        with_precomputed=with_precomputed,
        # P2D voxelizes only the target.
        precompute_source=False,
    )
