"""Example: appearance-based loop closure (Scan Context place recognition).

Pose-radius candidate search trusts the drifted trajectory: once drift
exceeds the radius, the revisit that would fix the drift is never even
proposed.  This demo builds a loop through a perceptually distinctive world,
corrupts the pose estimates with heavy simulated drift, and shows:

1. radius search misses the revisit (its drifted poses are far apart);
2. Scan Context retrieval finds it from appearance alone, with a coarse yaw
   estimate that seeds the closure registration;
3. ``run_slam(loop_detector="descriptor")`` closes the loop end to end.

The same pipeline from the CLI::

  python -m icp_tpu_torch.cli odometry --scans scans/*.csv \\
      -m trimmed --optimize --loop-descriptor 30 --loop-weight 100

Run: python -m icp_tpu_torch.examples.place_recognition
"""

import math
import os

import numpy as np
import torch

import icp_tpu_torch as icp
from icp_tpu_torch import geometry, pose_graph, slam
from icp_tpu_torch.geometry import default_dtype
from icp_tpu_torch.ops.descriptor import find_loop_candidates_descriptor, scan_context

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"


def make_world(n=400):
    """A distinctive 'place': harmonic walls."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    radius = 16.0 + 3.0 * np.sin(3 * ang + 0.4) + 1.5 * np.cos(7 * ang)
    return np.stack([radius * np.cos(ang), radius * np.sin(ang)], -1)


def main():
    rng = np.random.default_rng(3)
    world = make_world()
    t_steps = 14
    scans = []
    for k in range(t_steps):
        phi = 2 * math.pi * k / (t_steps - 1)
        px, py = 1.5 * math.cos(phi), 1.5 * math.sin(phi)
        th = 0.3 * math.sin(phi)
        c, s = np.cos(th), np.sin(th)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        scans.append(pts + rng.normal(0, 0.05, pts.shape))
    dtype = default_dtype(DEVICE)
    stack = icp.PointCloud(
        torch.tensor(np.stack(scans), dtype=dtype, device=DEVICE),
        torch.full((t_steps,), world.shape[0], dtype=torch.int32, device=DEVICE),
    )

    # Heavily drifted pose estimates: the revisit believed 8 m away.
    drifted = geometry.from_angle_2d(
        torch.zeros((t_steps,), dtype=dtype, device=DEVICE),
        torch.tensor(np.linspace(0, 8, t_steps)[:, None] * np.array([[1.0, 0.0]]), dtype=dtype,
                     device=DEVICE),
    )
    radius_cands = pose_graph.find_loop_candidates(drifted, radius=2.0, min_separation=8)
    print(f"radius search under drift: {len(radius_cands)} candidates")

    descs = scan_context(stack.points, stack.mask, max_radius=30.0)
    pairs, yaw = find_loop_candidates_descriptor(descs, 0.2, min_separation=8)
    print(f"descriptor search:         {len(pairs)} candidates "
          f"{pairs.cpu().numpy().tolist()} (yaw estimates "
          f"{np.round(yaw.cpu().numpy(), 2).tolist()} rad)")

    cfg = icp.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)
    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=1.0))
    result = slam.run_slam(
        stack, method, cfg,
        loop_detector="descriptor", descriptor_range=30.0,
        descriptor_max_distance=0.2, loop_min_separation=8,
        loop_weight=100.0, robust="gnc_gm",
    )
    end_raw = float(torch.linalg.vector_norm(result.trajectory.poses.translation[-1]))
    end_opt = float(torch.linalg.vector_norm(result.poses.translation[-1]))
    print(f"closures registered: {result.loop_edges.shape[0]}; end-pose error "
          f"(truth = identity): odometry {end_raw:.4f} m -> optimized {end_opt:.4f} m")


if __name__ == "__main__":
    main()
