"""Device mesh construction and multi-process bring-up.

Port of :mod:`icp_tpu.parallel.mesh`.  A ``torch.distributed`` device mesh
with two named dimensions:

* ``"data"``: batched scan pairs (data parallelism over registrations);
* ``"points"``: points within a cloud (one big cloud's correspondence
  problem split over ranks).

One rank is one process driving one device.  The defaults are the card's:
device type ``"cuda"`` and backend ``"nccl"``; the CPU (the tests) passes
``"cpu"`` and ``"gloo"``.  Without a card and without those arguments
:func:`make_mesh` and :func:`initialize_multihost` raise: there is no silent
CPU mesh.

JAX lays arrays out with ``NamedSharding``; the port's layouts are
:class:`Layout` descriptors (one mesh dimension name or None per tensor
dimension), and :func:`local_block` cuts a global tensor to this rank's
block.  Nothing here computes through DTensor: the NN kernel has no
sharding rule there, and DTensor would redistribute implicitly, hiding the
collectives that :mod:`icp_tpu_torch.parallel.comm` makes explicit.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
POINT_AXIS = "points"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: the default device type 'cuda' needs a CUDA card "
            "(pass device_type='cpu' / backend='gloo' to run on the host)")


def initialize_multihost(backend: str = "nccl", **kwargs) -> None:
    """Bring up the default process group; a no-op if it is already up.

    Reads the ``env://`` rendezvous (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, as ``torchrun`` sets them).  Without
    ``WORLD_SIZE`` in the environment the process is a world of one, through
    an in-process store (no socket).  ``kwargs`` go to
    ``torch.distributed.init_process_group``; its ``timeout`` bounds every
    collective, so that ranks that part ways fail instead of waiting.
    """
    if dist.is_initialized():
        return
    if backend == "nccl":
        _require_card("initialize_multihost")
    if "WORLD_SIZE" not in os.environ and "init_method" not in kwargs and "store" not in kwargs:
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group(backend=backend, **kwargs)


def make_mesh(
    data: int | None = None,
    points: int = 1,
    devices=None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``(data, points)`` mesh over ``devices`` (global ranks; default the
    whole world), brought up by :func:`initialize_multihost` if needed.

    ``data`` defaults to ``n // points``.  The data dimension is outermost,
    as in the JAX package: consecutive ranks (one host's devices) share a
    points group, whose combines are latency-sensitive, while the
    embarrassingly parallel data dimension spans hosts.
    """
    if device_type not in _BACKENDS:
        raise ValueError(f"unknown device type {device_type!r}; one of {sorted(_BACKENDS)}")
    if device_type == "cuda":
        _require_card("make_mesh")
    initialize_multihost(backend=_BACKENDS[device_type])
    ranks = torch.arange(dist.get_world_size()) if devices is None else torch.as_tensor(devices)
    n = ranks.numel()
    if data is None:
        if n % points != 0:
            raise ValueError(f"{n} devices not divisible by points={points}")
        data = n // points
    if data * points != n:
        raise ValueError(f"mesh {data}x{points} != {n} devices")
    return DeviceMesh(device_type, ranks.reshape(data, points),
                      mesh_dim_names=(DATA_AXIS, POINT_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line of the mesh along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Layout:
    """How a global tensor lies on ``mesh``: ``dims[k]`` is the mesh
    dimension that splits tensor dimension ``k`` into equal contiguous
    blocks (in rank order), or None; later tensor dimensions are whole.
    The counterpart of a JAX ``NamedSharding``."""

    mesh: DeviceMesh
    dims: tuple[str | None, ...]


def batch_sharding(mesh: DeviceMesh, trailing_dims: int) -> Layout:
    """Layout of a tensor whose axis 0 is the pair batch: split over ``data``."""
    return Layout(mesh, (DATA_AXIS,) + (None,) * trailing_dims)


def cloud_sharding(mesh: DeviceMesh, shard_points: bool) -> Layout:
    """Layout of batched cloud points ``(B, N, D)``; ``shard_points=True``
    also splits the point axis over ``points``."""
    return Layout(mesh, (DATA_AXIS, POINT_AXIS if shard_points else None, None))


def replicated(mesh: DeviceMesh) -> Layout:
    return Layout(mesh, ())


def local_block(tensor: torch.Tensor, layout: Layout) -> torch.Tensor:
    """This rank's block of the global ``tensor`` under ``layout``, contiguous,
    on this rank's device.  Raises if a split dimension does not divide."""
    block = tensor
    for dim, axis in enumerate(layout.dims):
        if axis is None:
            continue
        parts = axis_size(layout.mesh, axis)
        length = tensor.shape[dim]
        if length % parts:
            raise ValueError(f"dimension {dim} of size {length} is not divisible by the "
                             f"{parts} ranks of mesh axis {axis!r}")
        size = length // parts
        block = block.narrow(dim, axis_rank(layout.mesh, axis) * size, size)
    return block.to(mesh_device(layout.mesh)).contiguous()
