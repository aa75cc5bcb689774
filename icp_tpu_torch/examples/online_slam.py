"""Example: incremental (online) SLAM on the bundled ``ex_data/seq1`` sweeps.

Scans arrive one at a time, as on a robot: each registers against the
current keyframe; every few keyframes the back end searches for revisits,
registers them, and re-solves the keyframe graph with the robust GNC
kernel, re-anchoring the live pose, so drift corrections land mid-stream.
The same loop resumes from checkpoints
(``icp_tpu_torch.resilient.resumable_online_slam``) and runs from the CLI::

  python -m icp_tpu_torch.cli odometry --scans ex_data/seq1/sweep_*.conf \\
      -m trimmed --online --loop-radius 2.0 --odometry-weight 100 \\
      --loop-weight 100 --closure-information

Run: python -m icp_tpu_torch.examples.online_slam
"""

import glob
import json
import os

import numpy as np

import icp_tpu_torch as icp
from icp_tpu_torch import slam
from icp_tpu_torch.io import parse_sweep

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
QUICK = os.environ.get("ICP_EXAMPLES_QUICK") == "1"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEQ = os.path.join(REPO, "ex_data", "seq1")


def main():
    paths = sorted(glob.glob(os.path.join(SEQ, "sweep_*.conf")))
    if QUICK:
        paths = paths[:30]
    clouds = [parse_sweep(p, device=DEVICE) for p in paths]
    cap = max(c.capacity for c in clouds)
    clouds = [icp.pad_to(c, cap) for c in clouds]
    with open(os.path.join(SEQ, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])  # (T, 3) world [x, y, theta]
    # Ground truth in the scan-0 frame (the stream's gauge).
    c0, s0 = np.cos(gt[0, 2]), np.sin(gt[0, 2])
    gt_xy = (gt[:, :2] - gt[0, :2]) @ np.array([[c0, s0], [-s0, c0]]).T

    method = icp.from_method("trimmed", 2)
    cfg = icp.DriverConfig(max_iterations=150, angle_tolerance=1e-6, translation_tolerance=1e-6)
    online = slam.OnlineSlam(
        method, cfg,
        translation_threshold=0.5, angle_threshold=0.15,
        loop_every=8, loop_radius=2.0, loop_min_separation=10,
        robust="gnc_gm", robust_scale="auto",
        odometry_weight=100.0, loop_weight=100.0,
        closure_information=True,  # anisotropic corridor-aware closures
        device=DEVICE,
    )
    worst_live = 0.0
    for t, scan in enumerate(clouds):
        u = online.add_scan(scan)
        err = float(np.linalg.norm(u.pose.translation.cpu().numpy() - gt_xy[t]))
        worst_live = max(worst_live, err)
        if u.refined:
            print(f"scan {t:3d}: refinement ran, {u.num_closures} closures, "
                  f"live error {err:.3f} m")
    online.finalize()
    kf = online.keyframe_poses.translation
    # The last streamed sweep's ground truth (the JAX example reads the
    # sequence's last, which differs at ICP_EXAMPLES_QUICK's 30 sweeps).
    final_err = float(np.linalg.norm(online._pose.translation.cpu().numpy()
                                     - gt_xy[len(clouds) - 1]))
    print(f"stream done: {len(kf)} keyframes, {len(online._loop_edges)} closures, "
          f"final live error {final_err:.3f} m (worst during stream {worst_live:.3f} m)")
    return final_err


if __name__ == "__main__":
    main()
