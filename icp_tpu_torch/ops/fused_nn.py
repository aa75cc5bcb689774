"""Exact masked 1-NN with the matched coordinates: the CUDA kernel's wrapper.

Port of :mod:`icp_tpu.ops.fused_nn` (TPU kernel K1, ``_fused_nn_kernel``).
The kernel, ``csrc/nn.cu``, also serves :mod:`icp_tpu_torch.ops.pallas_nn`
(K2) with the coordinate carry off.  In the JAX package the kernels stayed
off the main path, because XLA fused the plain version better on the TPU.
PyTorch fuses nothing, and the plain version materializes ``(B, N, M)``
tensors several times per call, so on the card the kernel carries the main
path: the trimmed iterate takes the matched coordinates from it and needs no
gather.

A CUDA tensor always goes to the kernel; a CPU tensor takes
:func:`plain_fused_nearest_neighbors`.  :data:`LAUNCHES` counts every launch
of the kernel (K1 and K2) and :data:`COORD_LAUNCHES` those with the
coordinate carry (K1), so a run can show that it went through the kernel.
Under a points group's row split (:func:`icp_tpu_torch.ops.nn.row_split`)
each rank launches on its block of query rows and the rows are gathered
back.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .nn import nearest_neighbors, split_query_rows

LAUNCHES = 0
COORD_LAUNCHES = 0

_DTYPES = (torch.float32, torch.float64)


def plain_fused_nearest_neighbors(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    *,
    return_coords: bool = False,
):
    """The plain PyTorch version of the kernel: 1-NN, then a gather.

    A row whose best distance stayed +inf (no valid target) gets coordinates
    0, as the kernel (and K1 on the TPU) leaves its carry at its initial 0.
    """
    sq, idx = nearest_neighbors(query, targets, target_mask)
    if not return_coords:
        return sq, idx
    dim = targets.shape[-1]
    gathered = torch.take_along_dim(targets, idx.long()[..., None].expand(*idx.shape, dim), -2)
    zero = torch.zeros((), dtype=gathered.dtype, device=gathered.device)
    coords = torch.where(torch.isinf(sq)[..., None], zero, gathered)
    return sq, idx, coords


def check_nn_inputs(query, targets, target_mask):
    """Raise unless the inputs are what the kernel takes (on any device)."""
    if query.dim() < 2 or targets.dim() != query.dim():
        raise ValueError(
            f"query (..., N, D) and targets (..., M, D) need the same rank, got "
            f"{tuple(query.shape)} and {tuple(targets.shape)}"
        )
    dim = query.shape[-1]
    if dim not in (2, 3) or targets.shape[-1] != dim:
        raise ValueError(f"D must be 2 or 3 and equal, got {query.shape[-1]}, {targets.shape[-1]}")
    if query.shape[:-2] != targets.shape[:-2]:
        raise ValueError(
            f"leading dims differ: {tuple(query.shape[:-2])} vs {tuple(targets.shape[:-2])}"
        )
    if query.dtype not in _DTYPES or targets.dtype != query.dtype:
        raise TypeError(f"need float32 or float64 alike, got {query.dtype}, {targets.dtype}")
    tensors = [query, targets]
    if target_mask is not None:
        if target_mask.dtype != torch.bool:
            raise TypeError(f"target_mask must be bool, got {target_mask.dtype}")
        if target_mask.shape != targets.shape[:-1]:
            raise ValueError(
                f"target_mask {tuple(target_mask.shape)} != targets' {tuple(targets.shape[:-1])}"
            )
        tensors.append(target_mask)
    if any(t.device != query.device for t in tensors):
        raise ValueError("query, targets and target_mask must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("query, targets and target_mask must be contiguous")


def _bind():
    from .._build import load

    lib = load("nn")
    fn = lib.icp_nn_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.icp_nn_error_string.argtypes = [ctypes.c_int]
        lib.icp_nn_error_string.restype = ctypes.c_char_p
    return lib


def launch_nn_kernel(query, targets, target_mask, return_coords: bool):
    """Launch ``csrc/nn.cu`` on CUDA tensors already checked by :func:`check_nn_inputs`.

    Allocates the outputs, launches on the current stream without
    synchronising, and raises if the launch was refused.
    """
    global LAUNCHES, COORD_LAUNCHES
    if query.device.type != "cuda":
        raise ValueError(f"the NN kernel needs CUDA tensors, got {query.device}")
    lead = query.shape[:-2]
    n, dim = query.shape[-2:]
    m = targets.shape[-2]
    batch = math.prod(lead)
    dev = query.device
    sq = torch.empty((*lead, n), dtype=query.dtype, device=dev)
    idx = torch.empty((*lead, n), dtype=torch.int32, device=dev)
    coords = torch.empty((*lead, n, dim), dtype=query.dtype, device=dev) if return_coords else None
    if batch and n:
        lib = _bind()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.icp_nn_launch(
                query.data_ptr(),
                targets.data_ptr(),
                None if target_mask is None else target_mask.data_ptr(),
                sq.data_ptr(),
                idx.data_ptr(),
                None if coords is None else coords.data_ptr(),
                batch,
                n,
                m,
                dim,
                int(query.dtype == torch.float64),
                stream,
            )
        if err != 0:
            raise RuntimeError(f"NN kernel launch failed: {lib.icp_nn_error_string(err).decode()}")
        LAUNCHES += 1
        COORD_LAUNCHES += int(return_coords)
    return (sq, idx, coords) if return_coords else (sq, idx)


def fused_nearest_neighbors(
    query: torch.Tensor,
    targets: torch.Tensor,
    target_mask: torch.Tensor | None = None,
    *,
    return_coords: bool = False,
):
    """Exact masked 1-NN ``(..., N, D) x (..., M, D) -> (sq, idx[, coords])``.

    Leading dims are a batch (``vmap`` supplied it in JAX) and must match;
    ``target_mask`` is bool ``(..., M)`` or None (all valid).  Returns
    ``sq (..., N)`` in the input dtype, ``idx (..., N)`` int32 and, with
    ``return_coords``, the matched target coordinates ``(..., N, D)``.
    """
    check_nn_inputs(query, targets, target_mask)

    def rows(q):
        if q.device.type == "cpu":
            return plain_fused_nearest_neighbors(q, targets, target_mask,
                                                 return_coords=return_coords)
        return launch_nn_kernel(q, targets, target_mask, return_coords)

    return split_query_rows(rows, query)
