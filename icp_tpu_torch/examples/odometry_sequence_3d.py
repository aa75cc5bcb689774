"""Example: 3D LiDAR-sequence odometry and an SE(3) loop closure on
``ex_data/seq3d``.

``ex_data/seq3d`` is a 72-sweep, 12-ring x 128-azimuth raycast 3D LiDAR loop
with SE(3) ground truth:

  read per-sweep PLYs -> GICP chain_scans odometry ->
  SE(3) loop closure + robust (GNC) pose graph -> drift against the truth.

The same run from the CLI::

  python -m icp_tpu_torch.cli odometry --ply --scans ex_data/seq3d/sweep_*.ply \\
      -m gicp -c dim=3 neighbors=10 normal_neighbors=10 --optimize \\
      --loop-radius 2.0 --loop-min-separation 50 --robust-kernel gnc_gm

Run: python -m icp_tpu_torch.examples.odometry_sequence_3d
"""

import glob
import json
import os

import numpy as np
import torch

import icp_tpu_torch as icp
from icp_tpu_torch import slam

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
QUICK = os.environ.get("ICP_EXAMPLES_QUICK") == "1"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEQ = os.path.join(REPO, "ex_data", "seq3d")


def load_sequence(seq_dir=SEQ, count=None):
    paths = sorted(glob.glob(os.path.join(seq_dir, "sweep_*.ply")))[:count]
    clouds = [icp.from_points(icp.read_ply(p), capacity="bucket", dtype=torch.float32,
                              device=DEVICE) for p in paths]
    cap = max(c.capacity for c in clouds)
    scans = icp.stack([icp.pad_to(c, cap) for c in clouds])
    with open(os.path.join(seq_dir, "groundtruth.json")) as f:
        gt = json.load(f)
    n = len(paths)
    return scans, np.asarray(gt["rotations"])[:n], np.asarray(gt["translations"])[:n]


def main():
    scans, rot, tr = load_sequence(count=12 if QUICK else None)
    # Ground truth in the frame of sweep 0 (what the odometry estimates).
    gt_t0 = np.einsum("ij,tj->ti", rot[0].T, tr - tr[0])

    # GICP on multi-ring 3D data: the ring pattern shifts between poses, so
    # point-to-point pairs misbind across rings; GICP's local covariances
    # treat each ring patch as a plane.
    method = icp.from_method("gicp", 3, icp.Config(dim=3, neighbors=10, normal_neighbors=10))
    cfg = icp.DriverConfig(max_iterations=60, angle_tolerance=1e-5, translation_tolerance=1e-5)
    result = slam.run_slam(scans, method, cfg, loop_radius=2.0, loop_min_separation=50,
                           loop_weight=10.0, robust="gnc_gm")

    def err(poses):
        e = np.linalg.norm(poses.translation.double().cpu().numpy() - gt_t0, axis=-1)
        return float(np.sqrt((e ** 2).mean())), float(e[-1])

    ate_raw, end_raw = err(result.trajectory.poses)
    ate_opt, end_opt = err(result.poses)
    print(f"odometry:       ATE {ate_raw:.3f} m, end-pose error {end_raw:.3f} m")
    # edge_weights is None when no closure was accepted (a truncated
    # sequence that never revisits).
    loop_w = ([] if result.edge_weights is None else
              np.round(result.edge_weights[len(gt_t0) - 1:].cpu().numpy(), 3).tolist())
    print(f"loop closures:  {result.loop_edges.cpu().numpy().tolist()} "
          f"(robust weights {loop_w})")
    print(f"after closure:  ATE {ate_opt:.3f} m, end-pose error {end_opt:.3f} m")
    return end_raw, end_opt


if __name__ == "__main__":
    main()
