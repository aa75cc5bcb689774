"""Exact masked 1-NN ``(sq, idx)``: the wrapper of TPU kernel K2's port.

Port of :mod:`icp_tpu.ops.pallas_nn` (``_nn_kernel``).  On the TPU, K2 and K1
(:mod:`icp_tpu_torch.ops.fused_nn`) were two register layouts of one
computation; on the card both are ``csrc/nn.cu``, here with the coordinate
carry off.  A CUDA tensor goes to the kernel (counted in
``fused_nn.LAUNCHES``); a CPU tensor takes the plain
:func:`icp_tpu_torch.ops.nn.nearest_neighbors`.  Under a points group's row
split (:func:`icp_tpu_torch.ops.nn.row_split`) it runs on this rank's block
of query rows and gathers the rows back.
"""

from __future__ import annotations

import torch

from . import fused_nn
from .nn import nearest_neighbors, split_query_rows


def nearest_neighbors_pallas(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact masked 1-NN ``(..., N, D) x (..., M, D) -> (sq (..., N), idx (..., N) int32)``.

    Leading dims are a batch and must match; ``target_mask`` is bool
    ``(..., M)`` or None (all valid).
    """
    fused_nn.check_nn_inputs(query, targets, target_mask)

    def rows(q):
        if q.device.type == "cpu":
            return nearest_neighbors(q, targets, target_mask)
        return fused_nn.launch_nn_kernel(q, targets, target_mask, return_coords=False)

    return split_query_rows(rows, query)
