"""Example: register one 2D scan pair (the reference README's usage path).

Run: python -m icp_tpu_torch.examples.register_pair
"""

import os

import numpy as np

import icp_tpu_torch as icp

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    "ex_data")


def main():
    a = icp.parse_lidar_scan(f"{DATA}/scan1/first.csv", device=DEVICE)
    b = icp.parse_lidar_scan(f"{DATA}/scan1/second.csv", device=DEVICE)

    method = icp.from_method("trimmed", 2, icp.Config(overlap_rate=0.9))
    cfg = icp.DriverConfig(max_iterations=100, angle_tolerance=float(np.deg2rad(0.1)),
                           translation_tolerance=0.1)
    result, state = icp.converge(method, a, b, icp.identity(2, dtype=a.dtype, device=DEVICE),
                                 cfg)

    print(f"iterations: {int(result.iteration_count)}")
    print(f"cost:       {float(result.cost):.6f}")
    print(f"rotation:\n{result.transform.rotation.cpu().numpy()}")
    print(f"translation: {result.transform.translation.cpu().numpy()}")

    matches = icp.get_matches(state)
    costs = matches.cost[matches.valid].cpu().numpy()
    print(f"worst match cost: {costs.max():.4f}")


if __name__ == "__main__":
    main()
