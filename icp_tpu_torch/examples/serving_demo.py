"""Example: serve single-pair registration requests through the micro-batcher.

Many concurrent clients hit one BatchingRegistrar; each client gets exactly
its own pose back while the card sees batches.

Run: python -m icp_tpu_torch.examples.serving_demo
"""

import os
import threading
import time

import numpy as np

import icp_tpu_torch as icp
from icp_tpu_torch.serve import BatchingRegistrar

DEVICE = "cpu" if os.environ.get("ICP_EXAMPLES_CPU") == "1" else "cuda"
QUICK = os.environ.get("ICP_EXAMPLES_QUICK") == "1"  # smoke-test sizes


def main():
    rng = np.random.default_rng(0)
    n_clients = 8 if QUICK else 32
    server = BatchingRegistrar(
        icp.from_method("robust", 2),
        icp.DriverConfig(max_iterations=40, angle_tolerance=1e-4, translation_tolerance=1e-3),
        capacity=256,
        max_batch_size=16,
        max_delay=0.01,
        device=DEVICE,
    )
    base = rng.uniform(-20, 20, (200, 2)).astype(np.float32)
    shifts = rng.uniform(-2, 2, (n_clients, 2)).astype(np.float32)
    errors = np.zeros(n_clients)

    def client(k):
        result = server.register(base, base + shifts[k], timeout=600)
        errors[k] = np.linalg.norm(result.translation - shifts[k])

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    server.close()

    print(f"{n_clients} concurrent clients served in {dt:.2f}s ({n_clients / dt:.1f} req/s)")
    print(f"max pose error across clients: {errors.max():.5f}")
    if not errors.max() < 1e-2:
        raise SystemExit(f"a client's pose is off by {errors.max()}")


if __name__ == "__main__":
    main()
