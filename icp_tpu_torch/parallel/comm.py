"""The collectives of the parallel layer, over ``torch.distributed`` groups.

Port of what :mod:`icp_tpu.parallel` left to XLA: JAX annotated shardings
(GSPMD) or wrote ``psum`` / ``all_gather`` / ``ppermute`` inside a
``shard_map``, and XLA inserted the transfers.  PyTorch has no SPMD
partitioner, so every sharded path of the port moves its data through the
three helpers here, and each transfer is written where it happens.

NCCL takes CUDA tensors for every op.  Gloo (the CPU backend, and the one
that puts several ranks on one card, since NCCL will not) refuses CUDA
tensors for point-to-point ``send``/``recv``: :func:`ring_shift` moves a
CUDA tensor through host memory under gloo, and only there.  Its
``all_gather`` and ``all_reduce`` take CUDA tensors directly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _through_host(tensor: torch.Tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``tensor`` (equal shapes) concatenated along ``dim`` in
    the group's rank order."""
    # Bool travels as its bytes: not every backend reduces or gathers bool.
    src = tensor.contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.view(torch.bool) if tensor.dtype == torch.bool else out


def all_reduce(tensor: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``tensor`` reduced over the group (``op`` ``"sum"`` or ``"max"``), in
    place; every rank ends with the same values."""
    dist.all_reduce(tensor, op=_REDUCE_OPS[op], group=group)
    return tensor


class PendingShift:
    """A started :func:`ring_shift`; :meth:`wait` returns the received tensor."""

    def __init__(self, works, received: torch.Tensor, device: torch.device):
        self._works = works
        self._received = received
        self._device = device

    def wait(self) -> torch.Tensor:
        for work in self._works:
            work.wait()
        return self._received.to(self._device)


def ring_shift(tensor: torch.Tensor, group) -> PendingShift:
    """Start sending ``tensor`` to the next rank of the group (rank order,
    wrapping) and receiving the previous rank's tensor of the same shape:
    one step of a ring.  Returns at once, so that the caller computes while
    the shards travel."""
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    to_next = dist.get_global_rank(group, (rank + 1) % size)
    from_prev = dist.get_global_rank(group, (rank - 1) % size)
    send = tensor.cpu() if _through_host(tensor, group) else tensor.contiguous()
    received = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to_next, group),
        dist.P2POp(dist.irecv, received, from_prev, group),
    ])
    return PendingShift(works, received, tensor.device)
