"""Peaks of the card and the bound of the 1-NN work a call needs.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its
700 W limit): 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of
HBM.  The run prints the card's power limit beside them.

The bound is the arithmetic of ``chip_smoke.py::_bound``, counted over the
work the inputs need rather than the tensors a launch was given: for each
NN evaluation of a lane, its valid (query, target) pairs at ``3 D - 1``
flops each (D subtractions, D multiplications, D - 1 additions), and its
valid queries and targets read once and its outputs (a distance and an
index per query) written once.  A lane needs ``init`` evaluations when a
loop starts and ``iteration`` in each iteration it is active; lanes a loop
has frozen need none.  Each
launch (the loop's start, then its j-th iteration, which serves the lanes
still active there) is bound by the larger of its flops at the float32 peak
and its bytes at the memory rate, and the bounds add up.
"""

from __future__ import annotations

import numpy as np

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def launch_bound_s(n: np.ndarray, m: np.ndarray, dim: int, dtype_bytes: int) -> float:
    """The least seconds one launch over lanes of ``n`` valid queries and
    ``m`` valid targets could take."""
    flops = float(np.sum(n * m)) * (3 * dim - 1)
    ins = np.sum((n + m) * dim * dtype_bytes + m)  # points, and the targets' mask
    outs = np.sum(n * (dtype_bytes + 4))
    return max(flops / PEAK_F32_FLOPS, float(ins + outs) / PEAK_HBM_BYTES)


def nn_bound_s(levels, nn_per_lane: dict) -> float:
    """The bound of every NN evaluation of the given driver loops."""
    total = 0.0
    for lv in levels:
        n = np.asarray(lv.source_count, dtype=np.float64)
        m = np.asarray(lv.target_count, dtype=np.float64)
        it = np.asarray(lv.iterations)
        total += nn_per_lane.get("init", 0) * launch_bound_s(n, m, lv.dim, lv.dtype_bytes)
        for j in range(1, int(it.max(initial=0)) + 1):
            on = it >= j
            total += nn_per_lane.get("iteration", 0) * launch_bound_s(
                n[on], m[on], lv.dim, lv.dtype_bytes)
    return total
