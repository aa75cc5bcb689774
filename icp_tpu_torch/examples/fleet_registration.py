"""Example: register a fleet of scan pairs over a device mesh.

Started alone it is a world of one rank; under ``torchrun`` (or the
``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` variables it
sets) every rank registers its share of the batch, one card a rank
(``LOCAL_RANK`` picks it), and rank 0 prints the whole batch's result.

Run: python -m icp_tpu_torch.examples.fleet_registration
     torchrun --nproc-per-node 4 -m icp_tpu_torch.examples.fleet_registration
"""

import os

import numpy as np
import torch
import torch.distributed as dist

import icp_tpu_torch as icp
from icp_tpu_torch.parallel import make_mesh, make_sharded_converge_fn, shard_batch

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
QUICK = os.environ.get("ICP_EXAMPLES_QUICK") == "1"  # smoke-test sizes
N_PTS, CAP = (100, 128) if QUICK else (400, 512)


def main():
    if DEVICE == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    mesh = make_mesh(points=1, device_type=DEVICE)
    n_dev = dist.get_world_size()
    batch = 8 * max(n_dev // 8, 1) * 8  # divisible by the mesh

    rng = np.random.default_rng(0)
    a_clouds, b_clouds = [], []
    for _ in range(batch):
        pts = rng.uniform(-30, 30, (N_PTS, 2))
        ang = rng.uniform(-0.2, 0.2)
        c, s = np.cos(ang), np.sin(ang)
        moved = pts @ np.array([[c, s], [-s, c]]) + rng.uniform(-2, 2, 2)
        a_clouds.append(icp.from_points(pts, capacity=CAP, dtype=torch.float32, device="cpu"))
        b_clouds.append(icp.from_points(moved, capacity=CAP, dtype=torch.float32, device="cpu"))

    a, b = icp.stack(a_clouds), icp.stack(b_clouds)
    guess = icp.identity(2, (batch,), dtype=torch.float32, device="cpu")

    method = icp.from_method("robust", 2)
    cfg = icp.DriverConfig(max_iterations=50, angle_tolerance=1e-4, translation_tolerance=1e-3)
    fn = make_sharded_converge_fn(method, cfg, mesh)
    result, _ = fn(*shard_batch((a, b, guess), mesh))

    if dist.get_rank() == 0:
        iters = result.iteration_count.cpu().numpy()
        print(f"{batch} pairs on {n_dev} device(s)")
        print(f"iterations: min {iters.min()} max {iters.max()} mean {iters.mean():.1f}")
        print(f"costs: {result.cost.cpu().numpy()[:4]} ...")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
