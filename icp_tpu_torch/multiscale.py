"""Coarse-to-fine (multiscale) registration.

Port of :mod:`icp_tpu.multiscale` (``converge_multiscale``): converge on
stride-decimated clouds first, then refine at full resolution from the
coarse result under the caller's exact driver config.  An iteration on N/f
points costs about 1/f² of a full one for the N×M correspondence.
Multiscale is an accelerator, not a robustness feature: on sparse or highly
structured geometry the decimated problem can have another nearest minimum.
:func:`converge_ndt_multiscale` is NDT's own schedule, over cell sizes.
"""

from __future__ import annotations

import dataclasses

import torch

from .cloud import PointCloud
from .driver import ConvergenceState, DriverConfig, converge
from .geometry import RigidTransform
from .methods.base import Method
from .ops.coarse import coarse_align_2d, coarse_align_3d


def decimate(cloud: PointCloud, factor: int) -> PointCloud:
    """Stride-``factor`` subsample of a front-packed cloud, ``count = ceil(count / f)``.

    The strided slice is copied to a contiguous tensor, which the NN kernel
    needs.
    """
    if factor == 1:
        return cloud
    points = cloud.points[..., ::factor, :].contiguous()
    count = torch.div(cloud.count + factor - 1, factor, rounding_mode="floor")
    return PointCloud(points, count.to(torch.int32))


def converge_multiscale(
    method: Method,
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    config: DriverConfig,
    factors: tuple[int, ...] = (4,),
    coarse_max_iterations: int | None = None,
) -> tuple[ConvergenceState, object]:
    """Pyramid converge: coarse levels (largest factor first) seed the next.

    The full-resolution level runs last with ``config``; coarse levels use
    it with ``max_iterations`` capped at ``coarse_max_iterations``.  Returns
    the final level's ``(ConvergenceState, method state)``.
    """
    current = guess
    for f in sorted({int(x) for x in factors}, reverse=True):
        if f <= 1:
            continue
        cfg = _capped(config, coarse_max_iterations)
        result, _ = converge(method, decimate(source, f), decimate(target, f), current, cfg)
        current = result.transform
    return converge(method, source, target, current, config)


def _capped(config: DriverConfig, coarse_max_iterations: int | None) -> DriverConfig:
    """Driver config for a coarse level: iteration budget capped."""
    if coarse_max_iterations is None or (
        config.max_iterations is not None and coarse_max_iterations >= config.max_iterations
    ):
        return config
    coarse_min = config.min_iterations
    if coarse_min is not None:
        coarse_min = min(coarse_min, coarse_max_iterations)
    return dataclasses.replace(
        config, max_iterations=coarse_max_iterations, min_iterations=coarse_min
    )


def converge_ndt_multiscale(
    source: PointCloud,
    target: PointCloud,
    guess: RigidTransform,
    config: DriverConfig,
    dim: int = 2,
    ndt_config=None,
    scales: tuple[float, ...] = (4.0,),
    coarse_max_iterations: int | None = 10,
    decimate_factor: int | None = None,
    coarse_init: bool = False,
) -> tuple[ConvergenceState, object]:
    """Coarse-to-fine NDT: a cell-size schedule (Magnusson 2009 §6.5).

    Registration runs first at ``scale x cell_size`` for each entry of
    ``scales`` above 1 (largest first, at most ``coarse_max_iterations``
    iterations), on clouds stride-decimated by ``decimate_factor`` (default
    ``round(scale)``), each level seeding the next; then at the caller's NDT
    config (``ndt_config``, every key honoured at every level, only
    ``cell_size`` scaled) and driver config.  Returns the fine level's
    ``(ConvergenceState, method state)``.

    ``coarse_init=True`` replaces ``guess`` with the global initializer
    (:func:`~icp_tpu_torch.ops.coarse.coarse_align_2d` or ``_3d``): NDT's
    score surface is only as wide as its coarsest Gaussians, so use it where
    no trustworthy guess exists (global localization, map-merge seeding).
    """
    from .config import Config
    from .methods import from_method

    cfg = ndt_config if ndt_config is not None else Config()
    cell_size = float(cfg.get("cell_size", 1.0))
    current = guess
    if coarse_init:
        current = (coarse_align_2d if dim == 2 else coarse_align_3d)(source, target)
    for s in sorted((float(x) for x in scales), reverse=True):
        if s <= 1.0:
            continue
        coarse_method = from_method("ndt", dim, cfg.set("cell_size", cell_size * s).set("dim", dim))
        f = max(int(round(s)) if decimate_factor is None else decimate_factor, 1)
        result, _ = converge(coarse_method, decimate(source, f), decimate(target, f), current,
                             _capped(config, coarse_max_iterations))
        current = result.transform
    return converge(from_method("ndt", dim, cfg.set("dim", dim)), source, target, current, config)
