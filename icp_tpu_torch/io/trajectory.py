"""Trajectory export in the TUM RGB-D format (``timestamp tx ty tz qx qy qz
qw`` per line), the format of trajectory-evaluation tools (evo,
rpg_trajectory_evaluation).

Port of :mod:`icp_tpu.io.trajectory`, with its own copies of the quaternion
helpers of :mod:`icp_tpu.io.g2o`.  2D trajectories export with ``tz = 0`` and
a yaw-only quaternion.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import RigidTransform, default_dtype

__all__ = ["read_tum", "write_tum"]


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    """``(qx, qy, qz, qw)`` -> 3x3 rotation (normalized first)."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _rot_to_quat(rot: np.ndarray) -> np.ndarray:
    """3x3 rotation -> ``(qx, qy, qz, qw)`` with ``w >= 0`` (Shepperd's
    stable branch)."""
    m = rot
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 0.0)) * 2
        v = np.zeros(3)
        v[i] = 0.25 * s
        v[j] = (m[j, i] + m[i, j]) / s
        v[k] = (m[k, i] + m[i, k]) / s
        w = (m[k, j] - m[j, k]) / s
        x, y, z = v
    q = np.array([x, y, z, w])
    if q[3] < 0:
        q = -q
    return q / np.linalg.norm(q)


def write_tum(path: str, poses: RigidTransform, timestamps=None) -> None:
    """Write batched poses ``(T, ...)`` (on any device) as TUM lines;
    ``timestamps`` default to the frame index."""
    rot = poses.rotation.cpu().numpy()
    trans = poses.translation.cpu().numpy()
    t_total, dim = trans.shape
    if timestamps is None:
        timestamps = np.arange(t_total, dtype=np.float64)
    lines = []
    for k in range(t_total):
        if dim == 2:
            yaw = np.arctan2(rot[k, 1, 0], rot[k, 0, 0])
            q = np.array([0.0, 0.0, np.sin(yaw / 2), np.cos(yaw / 2)])
            txyz = (trans[k, 0], trans[k, 1], 0.0)
        else:
            q = _rot_to_quat(rot[k])
            txyz = tuple(trans[k])
        lines.append(f"{timestamps[k]:.6f} " + " ".join(f"{v:.9g}" for v in txyz) + " "
                     + " ".join(f"{v:.9g}" for v in q))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_tum(path: str, dim: int = 3, dtype=None, device="cuda"):
    """Read TUM lines into ``(timestamps (T,) numpy, RigidTransform)``, the
    poses on the card unless ``device="cpu"`` (``dtype`` defaults to float64
    on the CPU and float32 elsewhere).  ``dim=2`` projects to the plane:
    yaw from the quaternion, z dropped."""
    stamps, rots, trans = [], [], []
    with open(path) as f:
        for raw in f:
            tok = raw.split()
            if not tok or tok[0].startswith("#"):
                continue
            vals = [float(v) for v in tok]
            stamps.append(vals[0])
            r3 = _quat_to_rot(np.asarray(vals[4:8]))
            if dim == 2:
                yaw = np.arctan2(r3[1, 0], r3[0, 0])
                rots.append(np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]))
                trans.append(np.asarray(vals[1:3]))
            else:
                rots.append(r3)
                trans.append(np.asarray(vals[1:4]))
    dtype = default_dtype(device) if dtype is None else dtype
    poses = RigidTransform(torch.tensor(np.stack(rots), dtype=dtype, device=device),
                           torch.tensor(np.stack(trans), dtype=dtype, device=device))
    return np.asarray(stamps), poses
