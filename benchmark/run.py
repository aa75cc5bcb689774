"""Run one cell of the benchmark of ``icp_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root (the directory that holds ``BENCHMARK.json``)
on a machine with the CUDA cards the cell asks for; without them it exits
with code 3 and prints no result.  The last line of standard output is the
result as one JSON object; the compared numbers and their limits are the
last lines of standard error.  Build and kernel caches live under the
checkout's ``build/`` directory.
"""

import argparse
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
    sys.path.insert(0, BENCH)
    sys.path.insert(0, ROOT)
    import torch

    from harness import cell

    torch.set_num_threads(1)
    return cell.run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START,
                    root=ROOT)


if __name__ == "__main__":
    sys.exit(main())
