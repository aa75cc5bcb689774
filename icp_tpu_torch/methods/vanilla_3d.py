"""3D ``vanilla`` ICP.

Port of :mod:`icp_tpu.methods.vanilla_3d`, after
``lib/icp/impl/vanilla_3d.cpp``.  The reference's structure is kept:

* A **working copy** ``c`` of the source advances each iteration
  (``c = T * c``, ``vanilla_3d.cpp:90-93``); the accumulated
  ``transform = T * transform`` tracks it.
* Neighbour distances are ``sqrt(Euclidean)``: the k-d tree returns the
  Euclidean distance and ``nearest_neighbor`` takes another sqrt
  (``vanilla_3d.cpp:41``), so ``dist = sqrt(sqrt(sq))``.
* The base class's matches are never filled, so the driver-visible cost is
  exactly 0.0 (``icp.h:129,149-155``) and only the transform tolerances and
  the iteration cap end a run.  The mean neighbour distance
  (``vanilla_3d.cpp:98-106``) is kept as ``mean_nn_dist``;
  ``Config(parity=False)`` makes it the driver cost.

The correspondence is the CUDA kernel on the card: ``iterate`` takes the
matched target coordinates from
:func:`~icp_tpu_torch.ops.fused_nn.fused_nearest_neighbors` (K1) and fits on
them.  They are exact copies of target rows, so in float64 this is the
arithmetic of the JAX package's ``take`` gather.  ``solver`` (config key)
picks the 3D rotation solver: ``"auto"`` is SVD in float64 and Horn's
quaternion in float32.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import geometry
from ..cloud import PointCloud
from ..config import Config
from ..geometry import RigidTransform
from ..ops.fused_nn import fused_nearest_neighbors
from ..ops.rigid_fit import fit_rigid
from .base import Method, lane_targets


@dataclasses.dataclass(frozen=True)
class Vanilla3dState:
    transform: RigidTransform
    c: torch.Tensor  # (..., N, 3) working copy of the source points
    source: PointCloud
    target: PointCloud
    mean_nn_dist: torch.Tensor  # (...,) mean sqrt(Euclidean) NN distance


def _neighbors(c: torch.Tensor, target: PointCloud):
    """``(dist, coords)``: the double-sqrt distance of each working-copy point
    to its nearest valid target, and that target's coordinates."""
    points, mask = lane_targets(target, c.shape[:-2])
    sq, _, coords = fused_nearest_neighbors(c, points, mask, return_coords=True)
    return torch.sqrt(torch.sqrt(sq)), coords


def _mean_distance(dist: torch.Tensor, mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    d = dist.masked_fill(~mask, 0.0)
    n = torch.clamp(count.to(d.dtype), min=1.0)
    return d.sum(-1) / n


def working_copy_init(
    source: PointCloud, target: PointCloud, guess: RigidTransform
) -> Vanilla3dState:
    """The 3D family's init (``trimmed_3d`` shares it).

    Conscious deviation from ``vanilla_3d.cpp:71-73``, as in the JAX
    package: the reference resets the working copy to the raw source while
    ``transform`` starts at the guess, which counts a non-identity guess
    twice.  Here ``c = guess(source)``, so ``steps ∘ guess`` is the pose.
    """
    big = torch.full(
        source.batch_shape, torch.finfo(source.dtype).max, dtype=source.dtype,
        device=source.points.device,
    )
    return Vanilla3dState(guess, geometry.apply(guess, source.points), source, target, big)


def make_parity_cost(parity: bool):
    """The 3D family's driver cost: 0.0 in parity mode (the reference's
    unfilled matches), else the mean neighbour distance."""

    def cost(state: Vanilla3dState) -> torch.Tensor:
        if parity:
            return torch.zeros_like(state.mean_nn_dist)
        return state.mean_nn_dist

    return cost


def advance(state: Vanilla3dState, dist, coords, weights, solver: str) -> Vanilla3dState:
    """Fit a step onto the matched coordinates under ``weights``, move the
    working copy by it and compose it onto the pose.  The mean distance
    covers every valid source point, whatever the weights."""
    src = state.source
    step = fit_rigid(state.c, coords, weights, solver)
    return dataclasses.replace(
        state,
        transform=geometry.compose(step, state.transform),
        c=geometry.apply(step, state.c),
        mean_nn_dist=_mean_distance(dist, src.mask, src.count),
    )


def create(config: Config) -> Method:
    parity = bool(config.get("parity", 1))
    solver = config.get("solver", "auto")

    def iterate(state: Vanilla3dState) -> Vanilla3dState:
        dist, coords = _neighbors(state.c, state.target)
        weights = state.source.mask.to(state.source.dtype)
        return advance(state, dist, coords, weights, solver)

    return Method(
        name="vanilla", dim=3, init=working_copy_init, iterate=iterate,
        cost=make_parity_cost(parity),
    )
