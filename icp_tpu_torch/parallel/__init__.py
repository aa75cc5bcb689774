"""The distributed layer over ``torch.distributed`` (port of :mod:`icp_tpu.parallel`).

* :mod:`.mesh`: the named ``(data, points)`` device mesh, the process-group
  bring-up, layouts and :func:`local_block`.
* :mod:`.comm`: the collectives every sharded path goes through.
* :mod:`.converge`: batched registration over the mesh (lanes over
  ``data``, the correspondence rows over ``points``).
* :mod:`.sharded_nn`: target-split exact NN merged by an argmin over the
  gathered partials.
* :mod:`.ring_nn`: both clouds split, target blocks passed round a ring.
* :mod:`.big_cloud`: one pair split over ``points`` with one all-reduce of
  the Kabsch sums an iteration.

Defaults are the card's (``"cuda"``, NCCL); :func:`make_mesh` and
:func:`initialize_multihost` raise without a card unless the caller asks
for the CPU (``device_type="cpu"``, ``backend="gloo"``).
"""

from .mesh import (
    DATA_AXIS,
    POINT_AXIS,
    Layout,
    batch_sharding,
    cloud_sharding,
    initialize_multihost,
    local_block,
    make_mesh,
    replicated,
)
from .converge import make_sharded_converge_fn, shard_batch, sharded_converge_shardings
from .ring_nn import ring_nearest_neighbors
from .sharded_nn import sharded_nearest_neighbors
from .big_cloud import big_cloud_converge

__all__ = [
    "DATA_AXIS",
    "POINT_AXIS",
    "Layout",
    "batch_sharding",
    "big_cloud_converge",
    "cloud_sharding",
    "initialize_multihost",
    "local_block",
    "make_mesh",
    "make_sharded_converge_fn",
    "replicated",
    "ring_nearest_neighbors",
    "shard_batch",
    "sharded_converge_shardings",
    "sharded_nearest_neighbors",
]
