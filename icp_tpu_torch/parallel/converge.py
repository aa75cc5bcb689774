"""Mesh-sharded batched registration.

Port of :mod:`icp_tpu.parallel.converge`.  The JAX package kept
:func:`icp_tpu.driver.converge` unchanged, annotated the input shardings and
let XLA's SPMD partitioner insert the collectives.  PyTorch has no such
partitioner, so the port writes them, around the same unchanged
:func:`icp_tpu_torch.driver.converge`:

* ``data``: the pair batch is embarrassingly parallel.  Each rank of a data
  line runs ``converge`` on its lanes; its loop ends on its own lanes'
  ``active.any()``, and per-lane freezing keeps every lane's result what it
  is in one batch.  The per-lane results are all-gathered along the batch,
  so every rank returns the whole batched ``ConvergenceState``, as JAX
  does.
* ``points`` (``shard_points=True``): the correspondence search, the
  O(N·M) work, is split by query rows over the points group; the O(N) tail
  (trim, fit, driver) runs replicated.  Inside the run the 1-NN wrappers
  (``ops/fused_nn``, ``ops/pallas_nn``, reached from every NN method) and
  ``feature_aware``'s dense match compute this rank's block of rows and
  gather the rows back (:func:`icp_tpu_torch.ops.nn.row_split`);
  ``feature_aware``'s global-max normalization becomes an all-reduce of
  the maximum before the argmin.  Every rank of a points group then holds
  bit-identical state and leaves the driver loop on the same iteration:
  the gathered rows are the same bytes on every rank and the rest is the
  same deterministic computation on the same inputs.  Were they ever to
  part, the next collective would wait until the process group's timeout
  (:func:`icp_tpu_torch.parallel.mesh.initialize_multihost`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..cloud import PointCloud
from ..driver import ConvergenceState, DriverConfig, converge
from ..geometry import RigidTransform
from ..methods.base import Method
from ..ops.nn import splitting_rows
from .comm import all_gather, all_reduce
from .mesh import (
    DATA_AXIS,
    POINT_AXIS,
    Layout,
    axis_group,
    batch_sharding,
    cloud_sharding,
    local_block,
)


class RowSplit:
    """This rank's share of the query rows of a points group: rows padded to
    a multiple of the group size, block ``rank`` of ``size`` equal blocks."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def take(self, tensor: torch.Tensor, dim: int) -> torch.Tensor:
        n = tensor.shape[dim]
        block = -(-n // self.size)
        pad = block * self.size - n
        if pad:
            shape = list(tensor.shape)
            shape[dim] = pad
            tensor = torch.cat([tensor, tensor.new_zeros(shape)], dim=dim)
        return tensor.narrow(dim, self.rank * block, block).contiguous()

    def join(self, tensor: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        return all_gather(tensor, self.group, dim).narrow(dim, 0, n)

    def max(self, tensor: torch.Tensor) -> torch.Tensor:
        return all_reduce(tensor.contiguous(), self.group, "max")


def sharded_converge_shardings(mesh, shard_points: bool):
    """``(source, target, guess)`` layouts of batched inputs: a
    :class:`~icp_tpu_torch.cloud.PointCloud` and a
    :class:`~icp_tpu_torch.geometry.RigidTransform` of
    :class:`~icp_tpu_torch.parallel.mesh.Layout` leaves."""
    count = Layout(mesh, (DATA_AXIS,))
    source = PointCloud(points=cloud_sharding(mesh, shard_points), count=count)
    target = PointCloud(points=cloud_sharding(mesh, False), count=count)
    guess = RigidTransform(rotation=batch_sharding(mesh, 2), translation=batch_sharding(mesh, 1))
    return source, target, guess


def shard_batch(tree, mesh, shard_points: bool = False):
    """Cut a batched global ``(source, target, guess)`` to this rank's blocks
    on this rank's device (the layouts of :func:`sharded_converge_shardings`):
    the host-to-mesh transfer of ``ICP::begin``'s cloud copy
    (``icp.h:125-128``).  The batch must divide the ``data`` axis and, with
    ``shard_points``, the source capacity the ``points`` axis."""
    source, target, guess = tree
    src_s, tgt_s, guess_s = sharded_converge_shardings(mesh, shard_points)

    def cut(tree, layouts):
        return type(tree)(*(local_block(getattr(tree, f.name), getattr(layouts, f.name))
                            for f in dataclasses.fields(tree)))

    return cut(source, src_s), cut(target, tgt_s), cut(guess, guess_s)


def make_sharded_converge_fn(
    method: Method,
    config: DriverConfig,
    mesh,
    shard_points: bool = False,
):
    """Batched ``(source, target, guess) -> (ConvergenceState, state)`` over
    ``mesh``.

    The inputs are this rank's blocks as :func:`shard_batch` cuts them.
    The ``ConvergenceState`` is the whole batch's, on every rank, as the
    unsharded :func:`icp_tpu_torch.driver.converge` returns it; the method
    state is this rank's lanes (JAX leaves it sharded too).  With one rank
    the blocks are the whole batch, so ``serve.BatchingRegistrar(
    converge_fn=...)`` takes the function as it is.
    """
    data_group = axis_group(mesh, DATA_AXIS)
    split = RowSplit(axis_group(mesh, POINT_AXIS)) if shard_points else None

    def fn(source: PointCloud, target: PointCloud, guess: RigidTransform):
        if split is not None:
            # The source arrives split by rows; the replicated tail needs it
            # whole (O(N), once a run).
            source = PointCloud(all_gather(source.points, split.group, source.points.dim() - 2),
                                source.count)
        with splitting_rows(split):
            result, state = converge(method, source, target, guess, config)
        gathered = ConvergenceState(
            cost=all_gather(result.cost, data_group),
            iteration_count=all_gather(result.iteration_count, data_group),
            transform=RigidTransform(all_gather(result.transform.rotation, data_group),
                                     all_gather(result.transform.translation, data_group)),
        )
        return gathered, state

    return fn
