"""Coarse-to-fine (multiscale) registration.

Port of :mod:`icp_tpu.multiscale` (``converge_multiscale``): converge on
stride-decimated clouds first, then refine at full resolution from the
coarse result under the caller's exact driver config.  An iteration on N/f
points costs about 1/f² of a full one for the N×M correspondence.
Multiscale is an accelerator, not a robustness feature: on sparse or highly
structured geometry the decimated problem can have another nearest minimum.
"""

from __future__ import annotations

import dataclasses

import torch

from .cloud import PointCloud
from .driver import ConvergenceState, DriverConfig, converge
from .geometry import RigidTransform
from .methods.base import Method


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
