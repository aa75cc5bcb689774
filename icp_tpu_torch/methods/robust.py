"""Robust Welsch-weighted ICP (IRLS).

Port of :mod:`icp_tpu.methods.robust` (the Welsch kernel of "Fast and
Robust Iterative Closest Point", Zhang et al. 2021).  Each iteration's
rigid solve weights pair i by ``w_i = exp(-d_i^2 / (2 sigma^2))``, with the
kernel width annealed to ``sigma = max(sigma_min, nu * sqrt(median(d^2)))``.
The median is the radix k-th smallest of :mod:`icp_tpu_torch.ops.select`,
bit-equal to ``sort(v)[count // 2]``.

The correspondence is the 1-NN kernel's K2 wrapper on the card (init and
iterate); the fit gathers the matched rows (``fit_rigid_indexed``), as
``trimmed_3d`` does.

Config: ``nu`` (float, default 3.0), ``sigma_min`` (float, default 1e-3),
``dim`` (2 or 3).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.rigid_fit import fit_rigid_indexed
from ..ops.select import kth_smallest_value
from .base import Method, lane_targets, masked_rms, match

DEFAULT_NU = 3.0
DEFAULT_SIGMA_MIN = 1e-3


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of the masked entries per row: the ``count // 2 + 1``-th
    smallest, masked slots at +inf."""
    v = values.masked_fill(~mask, float("inf"))
    count = mask.sum(-1)
    return kth_smallest_value(v, count // 2 + 1)


@dataclasses.dataclass(frozen=True)
class RobustState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    match_idx: torch.Tensor  # (..., N) int32
    match_cost: torch.Tensor  # (..., N) squared NN distance
    sigma: torch.Tensor  # (...,) current kernel width


def create(config: Config) -> Method:
    nu = float(config.get("nu", DEFAULT_NU))
    sigma_min = float(config.get("sigma_min", DEFAULT_SIGMA_MIN))
    dim = int(config.get("dim", 2))

    def _matches(a_cur, target, src_mask):
        sq, idx = match(a_cur, target)
        sigma = torch.clamp(nu * torch.sqrt(masked_median(sq, src_mask)), min=sigma_min)
        return idx, sq.masked_fill(~src_mask, float("inf")), sigma

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> RobustState:
        a_cur = geometry.apply(guess, source.points)
        return RobustState(guess, source, target, *_matches(a_cur, target, source.mask))

    def iterate(state: RobustState) -> RobustState:
        src, tgt = state.source, state.target
        a_cur = geometry.apply(state.transform, src.points)
        idx, sq, sigma = _matches(a_cur, tgt, src.mask)
        sq_safe = sq.masked_fill(~src.mask, 0.0)
        w = torch.exp(-sq_safe / (2.0 * sigma[..., None] ** 2)) * src.mask.to(src.dtype)
        points, _ = lane_targets(tgt, a_cur.shape[:-2])
        step = fit_rigid_indexed(a_cur, points, idx, w)
        return dataclasses.replace(
            state, transform=geometry.compose(step, state.transform),
            match_idx=idx, match_cost=sq, sigma=sigma,
        )

    def cost(state: RobustState) -> torch.Tensor:
        return masked_rms(state.match_cost, state.source)

    return Method(name="robust", dim=dim, init=init, iterate=iterate, cost=cost)
