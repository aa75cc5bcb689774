"""Sequential scan odometry: trajectories from chained registrations.

Port of :mod:`icp_tpu.odometry`.  :func:`chain_scans` registers every
consecutive pair of a scan sequence in one batched ``converge`` (the T - 1
pairs are the batch axis) and composes the relative poses into a
trajectory with a log-depth scan over SE(D) (:func:`compose_chain`).  The
streams (:func:`stream_odometry`, :func:`stream_odometry_pipelined`)
register scans one at a time against the current keyframe.  Keyframe
selection (:func:`select_keyframes`) runs on the host, over ``.cpu()``
copies of the poses.

Not ported: ``chain_scans``' ``wrap_converge`` and ``pad_pairs_to_bucket``,
which existed only to share compiled XLA executables between sequences.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import geometry
from .cloud import PointCloud
from .driver import ConvergenceState, DriverConfig, converge, make_converge_fn
from .geometry import RigidTransform
from .methods.base import Method
from .multiscale import converge_multiscale
from .ops.coarse import coarse_align_2d, coarse_align_3d


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Absolute poses ``world_from_scan[t]`` of each scan, and the per-step
    registrations they were composed from."""

    poses: RigidTransform  # (T, D, D) / (T, D)
    relative: RigidTransform  # (T - 1, ...): scan t -> scan t + 1 frame
    registration: ConvergenceState  # per-pair costs and iteration counts


def compose_chain(relative: RigidTransform, initial: RigidTransform) -> RigidTransform:
    """Prefix-compose relative poses into absolute ones in ⌈log₂ T⌉ steps.

    ``poses[0] = initial``; ``poses[t + 1] = poses[t] ∘ inv(relative[t])``:
    registering scan t (source) onto scan t + 1 (target) gives the transform
    from frame t into frame t + 1, so the world pose advances by its
    inverse.  A Hillis-Steele scan: step s composes each element with the
    one ``2^s`` before it, one batched matmul per step.
    """
    rel_inv = geometry.inverse(relative)
    rot = torch.cat([initial.rotation[None], rel_inv.rotation])
    trans = torch.cat([initial.translation[None], rel_inv.translation])
    offset = 1
    while offset < rot.shape[0]:
        left_r, left_t = rot[:-offset], trans[:-offset]
        new_r = torch.matmul(left_r, rot[offset:])
        new_t = torch.matmul(left_r, trans[offset:, :, None])[..., 0] + left_t
        rot = torch.cat([rot[:offset], new_r])
        trans = torch.cat([trans[:offset], new_t])
        offset *= 2
    return RigidTransform(rot, trans)


def _map_aux(fn, aux):
    """``fn`` on every tensor of a method's precomputed data (a tensor, a
    named tuple of tensors, or None)."""
    if aux is None:
        return None
    if isinstance(aux, torch.Tensor):
        return fn(aux)
    return type(aux)(*(_map_aux(fn, x) for x in aux))


def chain_scans(
    scans: PointCloud,
    method: Method,
    config: DriverConfig,
    initial: RigidTransform | None = None,
    guesses: RigidTransform | None = None,
    coarse: bool = False,
    multiscale: bool = False,
) -> Trajectory:
    """Register every consecutive pair of a ``(T, N, D)`` scan stack and
    compose the trajectory.

    ``guesses`` (batch T - 1) seeds the registrations (identity by default).
    ``coarse=True`` seeds every pair with the global initializer
    (:func:`~icp_tpu_torch.ops.coarse.coarse_align_2d` or ``_3d``), which
    makes turns of 30+ degrees between consecutive scans recoverable.
    ``multiscale=True`` registers each pair through the coarse-to-fine
    pyramid (decimation 4, at most 30 coarse iterations).

    Methods with ``precompute`` (normals, surfel covariances, NDT maps)
    derive their per-scan data once for the whole stack: scan t is the
    target of pair t - 1 and the source of pair t.  Under ``multiscale``
    every level derives its own, since full-resolution data does not fit
    the decimated clouds.
    """
    t_total = scans.points.shape[0]
    if t_total < 2:
        raise ValueError("need at least two scans")
    dim = scans.dim
    device = scans.points.device
    sources = PointCloud(scans.points[:-1], scans.count[:-1])
    targets = PointCloud(scans.points[1:], scans.count[1:])
    if method.precompute is not None and method.with_precomputed is not None and not multiscale:
        aux = method.precompute(scans)
        method = method.with_precomputed(_map_aux(lambda x: x[:-1], aux),
                                         _map_aux(lambda x: x[1:], aux))
    if guesses is None and coarse:
        guesses = (coarse_align_2d if dim == 2 else coarse_align_3d)(sources, targets)
    elif guesses is None:
        guesses = geometry.identity(dim, (t_total - 1,), dtype=scans.dtype, device=device)
    if initial is None:
        initial = geometry.identity(dim, dtype=scans.dtype, device=device)
    if multiscale:
        result, _ = converge_multiscale(method, sources, targets, guesses, config,
                                        factors=(4,), coarse_max_iterations=30)
    else:
        result, _ = converge(method, sources, targets, guesses, config)
    poses = compose_chain(result.transform, initial)
    return Trajectory(poses=poses, relative=result.transform, registration=result)


def _angle(rotation: np.ndarray) -> float:
    if rotation.shape[-1] == 2:
        return abs(np.arctan2(rotation[1, 0], rotation[0, 0]))
    return abs(np.arccos(np.clip((np.trace(rotation) - 1) / 2, -1, 1)))


def select_keyframes(
    trajectory: Trajectory, translation_threshold: float, angle_threshold: float
) -> np.ndarray:
    """Indices of the keyframe scans (always 0 and the last scan), on the host.

    A scan becomes a keyframe when its pose has moved by more than the
    translation or the angle threshold since the previous keyframe.
    """
    rots = trajectory.poses.rotation.cpu().numpy()
    trans = trajectory.poses.translation.cpu().numpy()
    keep = [0]
    for t in range(1, len(trans)):
        k = keep[-1]
        dt = np.linalg.norm(trans[t] - trans[k])
        if dt > translation_threshold or _angle(rots[k].T @ rots[t]) > angle_threshold:
            keep.append(t)
    if keep[-1] != len(trans) - 1:
        keep.append(len(trans) - 1)
    return np.asarray(keep, dtype=np.int64)


def _advance(fn, keyframe, kf_pose, scan, translation_threshold, angle_threshold, guess):
    """Register ``keyframe -> scan``; the new pose and the keyframe predicate
    as a bool tensor (no host sync)."""
    if guess is None:
        guess = geometry.identity(scan.dim, dtype=scan.dtype, device=scan.points.device)
    result, _ = fn(keyframe, scan, guess)
    # The registration T takes keyframe points into the scan's frame: the
    # pose advances by inv(T).
    pose = geometry.compose(kf_pose, geometry.inverse(result.transform))
    delta_t = torch.linalg.vector_norm(pose.translation - kf_pose.translation, dim=-1)
    delta_a = torch.abs(geometry.rotation_angle(
        torch.matmul(pose.rotation, kf_pose.rotation.transpose(-1, -2))))
    return pose, (delta_t > translation_threshold) | (delta_a > angle_threshold), result


def stream_step(
    fn,
    keyframe: PointCloud,
    kf_pose: RigidTransform,
    scan: PointCloud,
    translation_threshold: float,
    angle_threshold: float,
    guess: RigidTransform | None = None,
):
    """One streaming-odometry advance: register ``keyframe -> scan`` with
    ``fn`` (``make_converge_fn``'s signature) and decide keyframe promotion.
    Returns ``(pose, is_keyframe: bool, result)``.

    ``guess`` seeds the registration (identity by default); when the
    keyframe gap spans real rotation, seed from the previous scan's
    keyframe-relative pose (``inv(kf_pose) ∘ prev_pose``).
    """
    pose, is_kf, result = _advance(fn, keyframe, kf_pose, scan, translation_threshold,
                                   angle_threshold, guess)
    return pose, bool(is_kf), result


def stream_odometry(
    scans,
    method: Method,
    config: DriverConfig,
    translation_threshold: float = 0.5,
    angle_threshold: float = 0.1,
    metrics=None,
):
    """Online odometry: register each scan of an iterable of clouds against
    the current keyframe, yielding ``(pose, is_keyframe, ConvergenceState)``
    per scan (the first scan: the identity, True, None).  The keyframe
    advances when the pose moves beyond the thresholds.

    ``metrics``: an optional :class:`icp_tpu_torch.utils.metrics.MetricsLogger`.
    """
    fn = make_converge_fn(method, config)
    keyframe = kf_pose = None
    for t, scan in enumerate(scans):
        if keyframe is None:
            keyframe = scan
            kf_pose = geometry.identity(scan.dim, dtype=scan.dtype, device=scan.points.device)
            yield kf_pose, True, None
            continue
        pose, is_kf, result = stream_step(
            fn, keyframe, kf_pose, scan, translation_threshold, angle_threshold)
        if metrics is not None:
            metrics.log("odometry_step", scan=t, iterations=int(result.iteration_count),
                        cost=float(result.cost), keyframe=is_kf)
        if is_kf:
            keyframe, kf_pose = scan, pose
        yield pose, is_kf, result


def stream_step_device(
    fn,
    keyframe: PointCloud,
    kf_pose: RigidTransform,
    scan: PointCloud,
    translation_threshold: float,
    angle_threshold: float,
    guess: RigidTransform | None = None,
):
    """:func:`stream_step` with the keyframe predicate as a bool tensor on the
    scan's device: the same arithmetic, no host sync of its own."""
    return _advance(fn, keyframe, kf_pose, scan, translation_threshold, angle_threshold, guess)


def stream_odometry_pipelined(
    scans,
    method: Method,
    config: DriverConfig,
    translation_threshold: float = 0.5,
    angle_threshold: float = 0.1,
    metrics=None,
):
    """:func:`stream_odometry` with scan t + 1's registration launched before
    scan t's keyframe predicate is read on the host.

    The semantics, exactly the JAX package's:

    * results come with one scan of latency (scan t's tuple after scan t + 1
      has been pulled from the iterator and launched; the last scan's when
      the iterator ends);
    * a promotion decided at scan t takes effect from scan t + 2's
      registration (t + 1 was already launched against the old keyframe).

    Between promotions the arithmetic is :func:`stream_odometry`'s.  The
    driver itself reads ``active.any()`` once per iteration, so on the card
    the overlap is at most the last iteration's tail.
    """
    fn = make_converge_fn(method, config)
    keyframe = kf_pose = None
    pending = None  # (scan, pose, is_kf, result) of scan t - 1 while t launches
    for t, scan in enumerate(scans):
        if keyframe is None:
            keyframe = scan
            kf_pose = geometry.identity(scan.dim, dtype=scan.dtype, device=scan.points.device)
            yield kf_pose, True, None
            continue
        pose, is_kf, result = stream_step_device(
            fn, keyframe, kf_pose, scan, translation_threshold, angle_threshold)
        if pending is not None:
            p_scan, p_pose, p_is_kf, p_result = pending
            promoted = bool(p_is_kf)
            if promoted:
                keyframe, kf_pose = p_scan, p_pose
            if metrics is not None:
                metrics.log("odometry_step", scan=t - 1, iterations=int(p_result.iteration_count),
                            cost=float(p_result.cost), keyframe=promoted)
            yield p_pose, promoted, p_result
        pending = (scan, pose, is_kf, result)
    if pending is not None:
        promoted = bool(pending[2])
        if metrics is not None:
            metrics.log("odometry_step", scan=-1, iterations=int(pending[3].iteration_count),
                        cost=float(pending[3].cost), keyframe=promoted)
        yield pending[1], promoted, pending[3]


def relative_pose(poses: RigidTransform, i, j) -> RigidTransform:
    """``pose_i^{-1} ∘ pose_j``: the pose of frame j in frame i."""
    pi = RigidTransform(poses.rotation[i], poses.translation[i])
    pj = RigidTransform(poses.rotation[j], poses.translation[j])
    return geometry.compose(geometry.inverse(pi), pj)
