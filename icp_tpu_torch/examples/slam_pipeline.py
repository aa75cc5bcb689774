"""Example: the complete SLAM pipeline as a library user would write it.

Generates a noisy circular scan sequence, then:
  odometry (coarse-seeded chain) -> loop-closure detection -> closure
  registration -> pose-graph optimization -> rendered trajectory.

Run: python -m icp_tpu_torch.examples.slam_pipeline   (writes slam_trajectory.png)
"""

import math
import os

import numpy as np
import torch

import icp_tpu_torch as icp
from icp_tpu_torch import geometry, odometry, pose_graph

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
OUT = os.environ.get("ICP_EXAMPLES_OUT") or os.getcwd()


def main():
    rng = np.random.default_rng(7)

    # --- Simulated world + circular trajectory with a closed loop ----------
    world = rng.uniform(-30, 30, (200, 2))
    t_steps, radius = 25, 4.0
    scans = []
    for k in range(t_steps):
        phi = 2 * math.pi * k / (t_steps - 1)
        px, py, th = radius * math.cos(phi), radius * math.sin(phi), phi + math.pi / 2
        c, s = np.cos(th), np.sin(th)
        pts = (world - [px, py]) @ np.array([[c, -s], [s, c]])
        scans.append(pts + rng.normal(0, 0.03, pts.shape))
    stack = icp.stack([icp.from_points(p, capacity=200, device=DEVICE) for p in scans])

    # --- Front end: batched odometry ----------------------------------------
    method = icp.from_method("robust", 2)
    cfg = icp.DriverConfig(max_iterations=50, angle_tolerance=1e-5, translation_tolerance=1e-5)
    traj = odometry.chain_scans(stack, method, cfg, coarse=True)
    drift = float(torch.linalg.vector_norm(traj.poses.translation[-1]))
    print(f"odometry end-pose drift: {drift:.4f}")

    # --- Back end: loop closure + pose graph --------------------------------
    cands = pose_graph.find_loop_candidates(traj.poses, radius=1.5,
                                            min_separation=t_steps - 3)
    print(f"loop candidates: {cands.cpu().numpy().tolist()}")
    edges, meas, _ = pose_graph.register_loop_closures(stack, traj.poses, cands, method, cfg,
                                                       max_cost=1.0)
    graph = pose_graph.graph_from_trajectory(
        traj.poses, geometry.inverse(traj.relative), loop_edges=edges, loop_measurements=meas,
        loop_weight=20.0)
    graph, gcosts = pose_graph.optimize(graph, iterations=10)
    print(f"graph cost: {float(gcosts[0]):.3e} -> {float(gcosts[-1]):.3e}")
    opt_drift = float(torch.linalg.vector_norm(graph.poses.translation[-1]))
    print(f"optimized end-pose drift: {opt_drift:.4f}")

    # --- Artifact (drawing needs matplotlib) ---------------------------------
    from icp_tpu_torch.vis import render_trajectory

    out = os.path.join(OUT, "slam_trajectory.png")
    try:
        render_trajectory(out, graph.poses, scans=stack)
        print(f"wrote {out}")
    except ImportError as e:
        print(f"render skipped: {e}")


if __name__ == "__main__":
    main()
