"""g2o pose-graph files (SE2 and SE3:QUAT vertices and edges).

Port of :mod:`icp_tpu.io.g2o`, with its own host-numpy parser.  The
de-facto interchange format of the SLAM ecosystem maps onto
:class:`icp_tpu_torch.pose_graph.PoseGraph`:

* ``VERTEX_SE2 id x y theta``
* ``EDGE_SE2 i j dx dy dtheta  i11 i12 i13 i22 i23 i33`` — the upper
  triangle of the 3x3 information in ``(x, y, theta)`` order;
* ``VERTEX_SE3:QUAT id x y z qx qy qz qw``
* ``EDGE_SE3:QUAT i j dx dy dz qx qy qz qw  <21 upper-triangle entries>``
  — the 6x6 information in ``(x, y, z, rx, ry, rz)`` order.

An edge measurement is the pose of vertex ``j`` in vertex ``i``'s frame,
``PoseGraph.measurements``, and the tangent order (translation, then
rotation) is :mod:`icp_tpu_torch.lie`'s.  Information matrices become
``sqrt_information`` with scalar weights 1; export folds the weights back
into the information.
"""

from __future__ import annotations

import numpy as np
import torch

from .trajectory import _quat_to_rot, _rot_to_quat

__all__ = ["read_g2o", "write_g2o"]

_TRI2 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
_TRI3 = [(i, j) for i in range(6) for j in range(i, 6)]


def _rot2(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _parse(lines):
    """Vertices by id and edges ``(i, j, measurement, information values)``."""
    vertices: dict[int, tuple] = {}
    edges = []
    dim = None
    for ln, raw in enumerate(lines):
        tok = raw.split()
        if not tok or tok[0].startswith("#"):
            continue
        tag = tok[0]
        if tag in ("VERTEX_SE2", "VERTEX_SE3:QUAT"):
            vdim = 2 if tag == "VERTEX_SE2" else 3
            if dim is not None and dim != vdim:
                raise ValueError(f"line {ln}: mixed SE2/SE3 records")
            dim = vdim
            vertices[int(tok[1])] = tuple(float(v) for v in tok[2:5 if vdim == 2 else 9])
        elif tag in ("EDGE_SE2", "EDGE_SE3:QUAT"):
            n_meas, n_info = (3, 6) if tag == "EDGE_SE2" else (7, 21)
            vals = [float(v) for v in tok[3:]]
            if len(vals) != n_meas + n_info:
                raise ValueError(f"line {ln}: {tag} needs {n_meas} + {n_info} values")
            edges.append((int(tok[1]), int(tok[2]), vals[:n_meas], vals[n_meas:]))
        # other tags (parameters, fixed markers) are skipped
    if dim is None or not vertices:
        raise ValueError("no SE2/SE3 vertices found")
    return dim, vertices, edges


def read_g2o(path_or_lines, *, dtype=None, device="cuda"):
    """Parse a g2o file (a path, or an iterable of lines) into a
    :class:`~icp_tpu_torch.pose_graph.PoseGraph` on ``device`` (the card
    unless ``device="cpu"``).

    Sparse or unordered vertex ids are remapped to dense ``0..T-1`` in
    ascending-id order.  Edge information matrices become the graph's
    ``sqrt_information``; if every edge carries the identity, the field is
    ``None`` (the cheaper scalar path).
    """
    from ..geometry import RigidTransform, default_dtype
    from ..ops.covariance import sqrt_information
    from ..pose_graph import PoseGraph

    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    dim, vertices, edges = _parse(lines)

    ids = sorted(vertices)
    remap = {vid: k for k, vid in enumerate(ids)}
    dof = 3 if dim == 2 else 6
    tri = _TRI2 if dim == 2 else _TRI3
    if dim == 2:
        rot = np.stack([_rot2(vertices[v][2]) for v in ids])
        trans = np.stack([np.asarray(vertices[v][:2]) for v in ids])
    else:
        rot = np.stack([_quat_to_rot(np.asarray(vertices[v][3:7])) for v in ids])
        trans = np.stack([np.asarray(vertices[v][:3]) for v in ids])

    e_ij, m_rot, m_trans, infos = [], [], [], []
    for i, j, meas, info_vals in edges:
        e_ij.append((remap[i], remap[j]))
        if dim == 2:
            # EDGE_SE2 stores the relative group pose (dx, dy, dtheta), not
            # an se(2) tangent.
            m_rot.append(_rot2(meas[2]))
            m_trans.append(np.asarray(meas[:2]))
        else:
            m_rot.append(_quat_to_rot(np.asarray(meas[3:7])))
            m_trans.append(np.asarray(meas[:3]))
        info = np.zeros((dof, dof))
        for (a, b), v in zip(tri, info_vals):
            info[a, b] = info[b, a] = v
        infos.append(info)
    infos = np.stack(infos) if infos else np.zeros((0, dof, dof))
    identity_info = bool(infos.shape[0] and np.allclose(infos, np.eye(dof)[None], atol=1e-12))

    dtype = default_dtype(device) if dtype is None else dtype

    def tensor(a):
        return torch.tensor(a, dtype=dtype, device=device)

    return PoseGraph(
        poses=RigidTransform(tensor(rot), tensor(trans)),
        edges_ij=torch.tensor(np.asarray(e_ij, dtype=np.int32).reshape(-1, 2), device=device),
        measurements=RigidTransform(
            tensor(np.stack(m_rot) if m_rot else np.zeros((0, dim, dim))),
            tensor(np.stack(m_trans) if m_trans else np.zeros((0, dim))),
        ),
        weights=torch.ones((len(edges),), dtype=dtype, device=device),
        # The factor is taken in float64 on the host, then cast.
        sqrt_information=None if identity_info else tensor(
            sqrt_information(torch.tensor(infos, dtype=torch.float64)).numpy()),
    )


def write_g2o(path: str, graph) -> None:
    """Write a :class:`~icp_tpu_torch.pose_graph.PoseGraph` (on any device)
    as g2o text.

    Scalar edge ``weights`` fold into the exported information (``w · L
    Lᵀ``, or ``w · I`` without ``sqrt_information``), so a round trip keeps
    the objective.
    """

    def host(x):
        return x.detach().cpu().numpy()

    rot = host(graph.poses.rotation)
    trans = host(graph.poses.translation)
    dim = trans.shape[-1]
    dof = 3 if dim == 2 else 6
    tri = _TRI2 if dim == 2 else _TRI3
    lines = []
    for k in range(trans.shape[0]):
        if dim == 2:
            theta = np.arctan2(rot[k, 1, 0], rot[k, 0, 0])
            lines.append(f"VERTEX_SE2 {k} {trans[k, 0]:.9g} {trans[k, 1]:.9g} {theta:.9g}")
        else:
            lines.append(f"VERTEX_SE3:QUAT {k} " + " ".join(f"{v:.9g}" for v in trans[k])
                         + " " + " ".join(f"{v:.9g}" for v in _rot_to_quat(rot[k])))
    e_ij = host(graph.edges_ij)
    m_rot = host(graph.measurements.rotation)
    m_trans = host(graph.measurements.translation)
    w = host(graph.weights)
    if graph.sqrt_information is not None:
        lt = host(graph.sqrt_information)
        info_all = np.einsum("eij,eik->ejk", lt, lt)  # L Lᵀ from Lᵀ
    else:
        info_all = np.broadcast_to(np.eye(dof), (e_ij.shape[0], dof, dof))
    for e in range(e_ij.shape[0]):
        info = info_all[e] * w[e]
        tri_vals = " ".join(f"{info[a, b]:.9g}" for a, b in tri)
        if dim == 2:
            dtheta = np.arctan2(m_rot[e][1, 0], m_rot[e][0, 0])
            lines.append(f"EDGE_SE2 {e_ij[e, 0]} {e_ij[e, 1]} "
                         f"{m_trans[e, 0]:.9g} {m_trans[e, 1]:.9g} {dtheta:.9g} {tri_vals}")
        else:
            lines.append(f"EDGE_SE3:QUAT {e_ij[e, 0]} {e_ij[e, 1]} "
                         + " ".join(f"{v:.9g}" for v in m_trans[e])
                         + " " + " ".join(f"{v:.9g}" for v in _rot_to_quat(m_rot[e]))
                         + " " + tri_vals)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
