"""Example: multi-session mapping, two SLAM runs merged into one map.

A robot maps the loop corridor (session A), is taken off duty, and is
redeployed later from the same dock (session B, its own world frame).
``slam.merge_sessions`` unions the two sessions into one continuing
``OnlineSlam``: B's trajectory is carried into A's frame through an anchor
transform, a bridge odometry edge makes the union one chain, and a
refinement finds the cross-session revisits and re-solves both
trajectories with the robust kernel.  The anchor comes from registering B's
first sweep onto A's dock keyframe (the known-rendezvous form;
descriptor-mode sessions can recover it by relocalization instead, with
``merge_sessions(a, b)`` and no anchor).

Data: ``ex_data/seq2loop`` (two laps of the seq1 world) split into lap 1 =
session A and lap 2 = session B, so every session-B pose revisits a
session-A pose.

Run: python -m icp_tpu_torch.examples.multi_session_merge
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
SEQ = os.path.join(REPO, "ex_data", "seq2loop")


def main():
    paths = sorted(glob.glob(os.path.join(SEQ, "sweep_*.conf")))
    lap1, lap2 = paths[:120], paths[120:]
    if QUICK:
        lap1, lap2 = lap1[:40], lap2[:40]  # the same arc, both laps
    with open(os.path.join(SEQ, "groundtruth.json")) as f:
        gt = np.asarray(json.load(f)["poses"])

    def load(ps):
        return [icp.pad_to(parse_sweep(p, device=DEVICE), 1024) for p in ps]

    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    cfg = icp.DriverConfig(max_iterations=50)

    def session():
        return slam.OnlineSlam(
            method, cfg,
            translation_threshold=0.5, angle_threshold=0.15,
            loop_every=8, loop_radius=2.0, loop_min_separation=10,
            robust="gnc_gm", robust_scale="auto",
            odometry_weight=100.0, loop_weight=100.0,
            device=DEVICE,
        )

    a = session()
    for s in load(lap1):
        a.add_scan(s)
    b = session()
    b_clouds = load(lap2)
    for s in b_clouds:
        b.add_scan(s)

    # Rendezvous anchor: lap 2 starts at the dock (= A's scan-0 pose), so
    # registering B's first sweep onto A's dock keyframe gives
    # world_a-from-world_b directly.
    dock = a._kf_clouds[0]
    res, _ = icp.converge(method, b_clouds[0], dock,
                          icp.identity(2, dtype=dock.dtype, device=DEVICE), cfg)
    merged, report = slam.merge_sessions(a, b, anchor=res.transform)
    print(f"merged sessions: {report.keyframes[0]} + {report.keyframes[1]} keyframes, "
          f"{report.new_closures} closures added by the joint refinement "
          f"({len(merged._loop_edges)} total)")

    # Merged end error: the last processed sweep's ground truth in A's
    # scan-0 frame.
    last_idx = 120 + len(lap2) - 1
    p0, th0 = gt[0, :2], gt[0, 2]
    c, s = np.cos(th0), np.sin(th0)
    want = (gt[last_idx, :2] - p0) @ np.array([[c, -s], [s, c]])
    got = merged._pose.translation.cpu().numpy()
    print(f"merged live-pose error vs ground truth: {np.linalg.norm(got - want):.3f} m")


if __name__ == "__main__":
    main()
