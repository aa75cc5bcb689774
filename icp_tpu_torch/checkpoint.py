"""Checkpoint / resume for trajectories and pose graphs.

Port of :mod:`icp_tpu.checkpoint`.  A tree of tensors (dicts, lists,
tuples and the port's dataclasses: ``RigidTransform``, ``PointCloud``,
``PoseGraph``) is saved to one ``.npz``: ``leaf_<i>`` in the JAX package's
leaf order (dict keys sorted, dataclass fields in declaration order, None
holding no leaf), so a file written by either package loads in the other
with equal leaves, plus a ``__treedef__`` manifest of the port's own (the
loaders read only the leaves).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .geometry import RigidTransform
from .pose_graph import PoseGraph


def _flatten(tree, leaves: list):
    """Append ``tree``'s leaves to ``leaves``; returns its structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        keys = sorted(tree)
        return {"dict": keys, "children": [_flatten(tree[k], leaves) for k in keys]}
    if isinstance(tree, (list, tuple)):
        return {type(tree).__name__: [_flatten(x, leaves) for x in tree]}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = [f.name for f in dataclasses.fields(tree)]
        return {"dataclass": type(tree).__name__, "fields": names,
                "children": [_flatten(getattr(tree, n), leaves) for n in names]}
    leaves.append(tree)
    return "leaf"


def _unflatten(like, leaves, position: list):
    """Rebuild ``like``'s structure from ``leaves`` (``position[0]`` is the
    next leaf); each leaf lands on the device of the tensor it replaces."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, position) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(x, leaves, position) for x in like]
        return type(like)(*out) if hasattr(like, "_fields") else type(like)(out)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name), leaves, position)
                             for f in dataclasses.fields(like)})
    array = leaves[position[0]]
    position[0] += 1
    device = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.as_tensor(array, device=device)


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree) -> None:
    """Serialize a tree of tensors to ``.npz`` (+ a structure manifest)."""
    leaves: list = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(json.dumps(structure).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_leaves(path: str) -> list[np.ndarray]:
    """The flat leaves saved by :func:`save_pytree` (either package's), in
    order."""
    data = np.load(path)
    n = sum(1 for k in data.files if k.startswith("leaf_"))
    return [data[f"leaf_{i}"] for i in range(n)]


def load_pytree(path: str, like):
    """Load into the structure of an existing tree ``like``; each leaf keeps
    the file's dtype and goes to the device of the tensor in ``like`` it
    replaces."""
    leaves = load_leaves(path)
    expected: list = []
    _flatten(like, expected)
    if len(expected) != len(leaves):
        raise ValueError(f"{path} holds {len(leaves)} leaves, the structure {len(expected)}")
    return _unflatten(like, leaves, [0])


def save_pose_graph(path: str, graph: PoseGraph) -> None:
    save_pytree(path, graph)


def load_pose_graph(path: str, device="cuda") -> PoseGraph:
    """A pose graph saved by :func:`save_pose_graph` (either package's), its
    tensors on ``device`` in the file's dtypes (``edges_ij`` as int32)."""
    leaves = load_leaves(path)
    rot, trans, edges, mrot, mtrans, weights = (
        torch.as_tensor(a, device=device) for a in leaves[:6])
    sqrt_info = torch.as_tensor(leaves[6], device=device) if len(leaves) > 6 else None
    return PoseGraph(
        poses=RigidTransform(rot, trans),
        edges_ij=edges.to(torch.int32),
        measurements=RigidTransform(mrot, mtrans),
        weights=weights,
        sqrt_information=sqrt_info,
    )
