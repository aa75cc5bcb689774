"""2D ``vanilla`` point-to-point ICP.

Port of :mod:`icp_tpu.methods.vanilla`, after ``lib/icp/impl/vanilla.cpp``,
with the reference's quirks:

* Matches are computed from the **untransformed** source
  (``compute_matches`` queries with ``a.col(i)``, ``vanilla.cpp:80``), so
  they never change.  They are computed once, in ``init``, with the CUDA
  kernel on the card (:func:`~icp_tpu_torch.ops.pallas_nn.nearest_neighbors_pallas`,
  K2), and each iterate fits on them by an exact gather.
* The match cost is ``sqrt(Euclidean) = sqrt(sqrt(sq))`` (``vanilla.cpp:84``
  on a k-d tree distance that is already Euclidean), zero on padding, so
  the driver cost ``sqrt(sum / n)`` never changes across iterations.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.pallas_nn import nearest_neighbors_pallas
from ..ops.rigid_fit import fit_rigid_indexed
from .base import Method, lane_targets


@dataclasses.dataclass(frozen=True)
class VanillaState:
    transform: RigidTransform
    source: PointCloud
    target: PointCloud
    match_idx: torch.Tensor  # (..., N) int32, fixed for the whole run
    match_cost: torch.Tensor  # (..., N) sqrt(Euclidean NN distance), fixed


def _compute_matches(source: PointCloud, target: PointCloud):
    points, mask = lane_targets(target, source.points.shape[:-2])
    sq, idx = nearest_neighbors_pallas(source.points, points, mask)
    cost = torch.sqrt(torch.sqrt(sq)).masked_fill(~source.mask, 0.0)
    return idx, cost


def create(config: Config) -> Method:
    del config  # vanilla takes no parameters (``vanilla.cpp:17``)

    def init(source: PointCloud, target: PointCloud, guess: RigidTransform) -> VanillaState:
        idx, cost = _compute_matches(source, target)
        return VanillaState(guess, source, target, idx, cost)

    def iterate(state: VanillaState) -> VanillaState:
        src, tgt = state.source, state.target
        a_current = geometry.apply(state.transform, src.points)
        weights = src.mask.to(src.dtype)
        step = fit_rigid_indexed(a_current, tgt.points, state.match_idx, weights)
        return dataclasses.replace(state, transform=geometry.compose(step, state.transform))

    def cost(state: VanillaState) -> torch.Tensor:
        # calculate_cost = sqrt(mean(match costs)) over valid source points
        # (``icp.h:149-155``).
        n = torch.clamp(state.source.count.to(state.match_cost.dtype), min=1.0)
        return torch.sqrt(state.match_cost.sum(-1) / n)

    return Method(name="vanilla", dim=2, init=init, iterate=iterate, cost=cost)
