"""Example: LiDAR-sequence odometry on the bundled ``ex_data/seq1`` dataset.

``ex_data/seq1`` is a 120-sweep, 540-beam raycast LiDAR loop in the
reference's ``.conf`` sweep format, with ground-truth poses alongside:

  parse sweeps -> chain_scans odometry -> loop-closure pose graph ->
  absolute trajectory error against the ground truth.

The same run from the CLI::

  python -m icp_tpu_torch.cli odometry --scans ex_data/seq1/sweep_*.conf \\
      --method trimmed --max-iterations 150 --loop-radius 2.0 --render seq1.png

Run: python -m icp_tpu_torch.examples.odometry_sequence
"""

import glob
import json
import os

import numpy as np

import icp_tpu_torch as icp
from icp_tpu_torch import geometry, odometry, pose_graph
from icp_tpu_torch.io import parse_sweep

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
QUICK = os.environ.get("ICP_EXAMPLES_QUICK") == "1"
OUT = os.environ.get("ICP_EXAMPLES_OUT") or os.getcwd()
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEQ = os.path.join(REPO, "ex_data", "seq1")


def load_sequence(seq_dir=SEQ, count=None):
    paths = sorted(glob.glob(os.path.join(seq_dir, "sweep_*.conf")))[:count]
    clouds = [parse_sweep(p, device=DEVICE) for p in paths]
    cap = max(c.capacity for c in clouds)
    scans = icp.stack([icp.pad_to(c, cap) for c in clouds])
    with open(os.path.join(seq_dir, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])[: len(paths)]  # (T, 3): x, y, theta
    return scans, gt


def gt_relative_to_start(gt):
    """Ground-truth poses in the frame of sweep 0 (what the odometry chain
    estimates): p_t^0 = R_0^T (p_t - p_0), th_t - th_0."""
    x0, y0, th0 = gt[0]
    c, s = np.cos(th0), np.sin(th0)
    r0t = np.array([[c, s], [-s, c]])
    xy = (gt[:, :2] - [x0, y0]) @ r0t.T
    return xy, gt[:, 2] - th0


def ate(poses, gt_xy):
    """Absolute trajectory error of the estimated translations."""
    err = np.linalg.norm(poses.translation.cpu().numpy() - gt_xy, axis=-1)
    return float(err.mean()), float(err.max())


def main():
    scans, gt = load_sequence(count=30 if QUICK else None)
    gt_xy, _ = gt_relative_to_start(gt)
    # Hard-overlap `trimmed` keeps the along-corridor constraints (end walls,
    # pillars) in the solve, where median-scale robust kernels can anneal
    # them away and slide along the walls.
    method = icp.from_method("trimmed", 2)
    cfg = icp.DriverConfig(max_iterations=150, angle_tolerance=1e-6, translation_tolerance=1e-6)

    # --- Front end: scan-to-scan odometry (sensor-rate sweeps are near the
    # identity, so no coarse seeding) -------------------------------------------
    traj = odometry.chain_scans(scans, method, cfg)
    mean_e, max_e = ate(traj.poses, gt_xy)
    print(f"odometry ATE: mean {mean_e:.3f} m, max {max_e:.3f} m "
          f"(path length ~{np.linalg.norm(np.diff(gt_xy, axis=0), axis=-1).sum():.0f} m)")

    # --- Back end: loop closure + pose graph ---------------------------------
    cands = pose_graph.find_loop_candidates(traj.poses, radius=2.0,
                                            min_separation=len(gt) - 12)
    edges, meas, _ = pose_graph.register_loop_closures(scans, traj.poses, cands, method, cfg,
                                                       max_cost=1.0, coarse=True)
    print(f"loop closures: {len(edges)} of {len(cands)} candidates accepted")
    graph = pose_graph.graph_from_trajectory(
        traj.poses, geometry.inverse(traj.relative), loop_edges=edges, loop_measurements=meas,
        loop_weight=20.0)
    graph, gcosts = pose_graph.optimize(graph, iterations=10)
    mean_o, max_o = ate(graph.poses, gt_xy)
    print(f"pose-graph cost {float(gcosts[0]):.3e} -> {float(gcosts[-1]):.3e}")
    print(f"optimized ATE: mean {mean_o:.3f} m, max {max_o:.3f} m")

    from icp_tpu_torch.vis import render_trajectory

    out = os.path.join(OUT, "seq1_trajectory.png")
    try:  # drawing needs matplotlib
        render_trajectory(out, graph.poses, scans=scans)
        print(f"wrote {out}")
    except ImportError as e:
        print(f"render skipped: {e}")
    return mean_e, mean_o


if __name__ == "__main__":
    main()
