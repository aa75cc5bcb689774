"""Big-cloud registration: ONE scan pair split over the ``points`` axis.

Port of :mod:`icp_tpu.parallel.big_cloud`.  When one cloud outgrows one
device, its points are split over the ranks of the points group and each
iteration's reductions are explicit collectives:

* each rank moves its block of the source's working copy and matches it
  against the target with the 1-NN kernel's K1 wrapper (the matched
  coordinates come with the match, so nothing is gathered by index);
* the weighted Kabsch needs six global sums (Σw, Σw·a, Σw·b, Σw·a⊗b,
  Σ dist, the valid count), packed into one vector and reduced with one
  ``all_reduce``: the loop is host-bound, so one collective an iteration,
  not six; the D×D rotation solve then runs replicated on every rank
  (:func:`icp_tpu_torch.ops.rigid_fit._rotation_from_h`);
* the loop (the iteration cap, and the transform tolerance with the
  previous pose carried) is a Python loop on the host.

``target_mode="gather"`` all-gathers the target once per run (O(M) per
rank); ``"ring"`` keeps it split and runs the ring fold of
:mod:`icp_tpu_torch.parallel.ring_nn` every iteration (O(M/P) per rank).

This is the working-copy scheme of the 3D family (``vanilla_3d.cpp:90-93``)
in 2D or 3D, with an optional distance gate (``trimmed_3d.cpp:97-102``):
ungated it is a split ``vanilla_3d``, gated a split ``trimmed_3d``.  The
distance keeps the reference's ``sqrt(Euclidean)`` semantics.
"""

from __future__ import annotations

import torch

from .. import geometry
from ..geometry import RigidTransform
from ..ops.fused_nn import fused_nearest_neighbors
from ..ops.rigid_fit import _rotation_from_h
from .comm import all_gather, all_reduce
from .mesh import POINT_AXIS, axis_group
from .ring_nn import ring_fold
from .sharded_nn import check_equal_blocks


def big_cloud_converge(
    source_points: torch.Tensor,
    source_mask: torch.Tensor,
    target_points: torch.Tensor,
    target_mask: torch.Tensor,
    guess: RigidTransform,
    mesh,
    *,
    max_iterations: int,
    angle_tolerance: float | None = None,
    translation_tolerance: float | None = None,
    max_distance: float | None = None,
    solver: str = "auto",
    target_mode: str = "gather",
) -> tuple[RigidTransform, int, torch.Tensor]:
    """Register one split pair; returns ``(transform, iterations, mean_nn)``.

    ``source_points (n, D)`` / ``source_mask (n,)`` and ``target_points
    (m, D)`` / ``target_mask (m,)`` are this rank's blocks of the two clouds
    along ``points`` (the global N and M must divide the axis size);
    ``guess`` is whole on every rank.  The transform and ``mean_nn`` (a 0-d
    tensor) are equal on every rank.
    """
    if (angle_tolerance is None) != (translation_tolerance is None):
        raise ValueError("angle_tolerance and translation_tolerance must be set together")
    if target_mode not in ("gather", "ring"):
        raise ValueError(f"unknown target_mode {target_mode!r}")
    group = axis_group(mesh, POINT_AXIS)
    check_equal_blocks(group, source_points.shape[0], target_points.shape[0])
    dim = source_points.shape[-1]
    dtype = source_points.dtype
    tiny = torch.finfo(dtype).tiny
    w_src = source_mask.to(dtype)
    if target_mode == "gather":
        tgt_full = all_gather(target_points, group)
        tmask_full = all_gather(target_mask, group)

    def step(rot, trans, c):
        if target_mode == "ring":
            sq, _, matched = ring_fold(c, target_points, target_mask, group, with_points=True)
        else:
            sq, _, matched = fused_nearest_neighbors(c, tgt_full, tmask_full, return_coords=True)
        dist = torch.sqrt(torch.sqrt(sq))  # the reference's sqrt(Euclidean)
        w = w_src if max_distance is None else torch.where(dist <= max_distance, w_src, 0.0)
        wc = c * w[:, None]
        sums = all_reduce(torch.cat([
            w.sum()[None], wc.sum(0), (matched * w[:, None]).sum(0),
            torch.matmul(wc.T, matched).reshape(-1),
            (dist * w_src).sum()[None], w_src.sum()[None],
        ]), group)
        sw, swa, swb = sums[0], sums[1:1 + dim], sums[1 + dim:1 + 2 * dim]
        swab = sums[1 + 2 * dim:1 + 2 * dim + dim * dim].reshape(dim, dim)
        sdist, scount = sums[-2], sums[-1]
        sw_safe = torch.clamp(sw, min=tiny)
        ca, cb = swa / sw_safe, swb / sw_safe
        h = swab - torch.outer(swa, swb) / sw_safe
        r_step = _rotation_from_h(h, solver)
        t_step = cb - torch.matmul(r_step, ca)
        c_new = torch.matmul(c, r_step.T) + t_step
        rot_new = torch.matmul(r_step, rot)
        trans_new = torch.matmul(r_step, trans) + t_step
        return rot_new, trans_new, c_new, sdist / torch.clamp(scount, min=1.0)

    rot, trans = guess.rotation, guess.translation
    c = torch.matmul(source_points, rot.T) + trans  # respect the guess
    mean_nn = torch.tensor(torch.finfo(dtype).max, dtype=dtype, device=source_points.device)
    it = 0
    prev = None
    while it < max_iterations:
        # Every value read here comes from the all-reduced sums, equal on
        # every rank, so all ranks leave the loop on the same iteration and
        # the next collective never waits for a rank that left.
        if angle_tolerance is not None and prev is not None:
            angle = geometry.rotation_angle(torch.matmul(rot, prev[0].T))
            tdelta = torch.linalg.vector_norm(trans - prev[1])
            if bool((torch.abs(angle) < angle_tolerance) & (tdelta < translation_tolerance)):
                break
        prev = (rot, trans)
        rot, trans, c, mean_nn = step(rot, trans, c)
        it += 1
    return RigidTransform(rot, trans), it, mean_nn
