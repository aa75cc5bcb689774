"""Multi-outlier robustness evaluation of the pose-graph back end.

Port of :mod:`icp_tpu.robustness`: the Vertigo-style protocol (Sünderhauf &
Protzel, ICRA 2012, on Olson's Manhattan graphs).  Wrong loop closures are
injected into a pose graph at controlled rates and structures, each robust
kernel solves it, and each solve reports

* closure classification: precision and recall of outlier rejection from
  the converged IRLS weights, and the share of true closures kept;
* trajectory quality: the Umeyama-aligned ATE (:mod:`icp_tpu_torch.eval`)
  against the outlier-free oracle solve.

Injection is host numpy with the JAX package's random draws in the same
order, so a given ``(graph, rate, mode, seed)`` gives the same corrupted
graph, bit for bit, on both sides.  ``'random'`` false closures join
independent random node pairs with gross random measurements;
``'clustered'`` ones come in mutually consistent groups that agree on one
wrong rigid offset (perceptual aliasing).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import pose_graph
from .geometry import RigidTransform

__all__ = [
    "closure_mask",
    "inject_outliers",
    "classify_closures",
    "run_protocol",
]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def closure_mask(graph, min_separation: int = 2) -> torch.Tensor:
    """Bool ``(E,)`` mask of loop-like edges on the graph's device: id span
    >= ``min_separation``, or backward (g2o files need not list odometry
    first)."""
    ij = _host(graph.edges_ij)
    span = ij[:, 1] - ij[:, 0]
    return torch.as_tensor((span < 0) | (np.abs(span) >= min_separation),
                           device=graph.edges_ij.device)


def _random_rotations(rng, n: int, dim: int) -> np.ndarray:
    if dim == 2:
        th = rng.uniform(-np.pi, np.pi, n)
        c, s = np.cos(th), np.sin(th)
        return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
    # Uniform-ish 3D rotations: QR of Gaussian matrices with a det fix.
    rots = []
    for _ in range(n):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        if np.linalg.det(q) < 0:
            q[:, -1] = -q[:, -1]
        rots.append(q)
    return np.stack(rots) if rots else np.zeros((0, 3, 3))


def inject_outliers(
    graph,
    rate: float,
    mode: str = "random",
    seed: int = 0,
    min_separation: int = 20,
    cluster_size: int = 8,
    robust_edges=None,
):
    """Append false loop closures to ``graph``; returns ``(corrupted_graph,
    is_outlier (E+n,) bool, robust_edges (E+n,) bool)``.

    ``rate`` is the share of the corrupted graph's closures that are false:
    ``round(rate / (1 - rate) · n_true)`` are injected.  ``robust_edges``
    marks the existing closures (default :func:`closure_mask`); each
    injected edge copies the weight and information block of a random
    existing closure.  ``mode='random'``: node pairs with id span >=
    ``min_separation`` and gross measurements (uniform rotation,
    translation uniform over the trajectory's bounding box).
    ``mode='clustered'``: ``cluster_size``-edge groups ``(i0+k, j0+k)``
    whose measurements all satisfy one wrong offset ``Z = X_i⁻¹ · D ·
    X_j``.
    """
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if mode not in ("random", "clustered"):
        raise ValueError(f"unknown mode {mode!r}; 'random' or 'clustered'")
    device = graph.edges_ij.device
    if robust_edges is None:
        robust_edges = closure_mask(graph)
    rob = _host(robust_edges).astype(bool)
    n_edges = graph.num_edges
    n_true = int(rob.sum())
    n_nodes = graph.num_nodes
    dim = graph.dim
    n_inj = int(round(rate / (1.0 - rate) * n_true))
    is_outlier = np.zeros(n_edges, dtype=bool)
    if n_inj == 0:
        return (graph, torch.as_tensor(is_outlier, device=device),
                torch.as_tensor(rob, device=device))

    rng = np.random.default_rng(seed)
    rot_np = _host(graph.poses.rotation).astype(np.float64)
    trans_np = _host(graph.poses.translation).astype(np.float64)

    if mode == "random":
        ij = np.zeros((n_inj, 2), dtype=np.int64)
        for k in range(n_inj):
            while True:
                i = int(rng.integers(0, n_nodes))
                j = int(rng.integers(0, n_nodes))
                if j - i >= min_separation:
                    ij[k] = (i, j)
                    break
        lo, hi = trans_np.min(axis=0), trans_np.max(axis=0)
        m_rot = _random_rotations(rng, n_inj, dim)
        m_trans = rng.uniform(lo, hi, (n_inj, dim))
    else:
        ij_list, rot_list, trans_list = [], [], []
        extent = float(np.ptp(trans_np, axis=0).max()) or 1.0
        while len(ij_list) < n_inj:
            c = min(cluster_size, n_inj - len(ij_list))
            while True:
                i0 = int(rng.integers(0, n_nodes - c))
                j0 = int(rng.integers(0, n_nodes - c))
                if j0 - i0 >= min_separation + c:
                    break
            # The common wrong hypothesis D, a rigid world offset.
            d_rot = _random_rotations(rng, 1, dim)[0]
            d_trans = rng.uniform(-0.3, 0.3, dim) * extent
            for k in range(c):
                i, j = i0 + k, j0 + k
                ij_list.append((i, j))
                rot_list.append(rot_np[i].T @ (d_rot @ rot_np[j]))
                trans_list.append(rot_np[i].T @ (d_rot @ trans_np[j] + d_trans - trans_np[i]))
        ij = np.asarray(ij_list)
        m_rot = np.stack(rot_list)
        m_trans = np.stack(trans_list)

    # Injected edges claim the confidence of real closures.
    donor = np.flatnonzero(rob)[rng.integers(0, n_true, n_inj)]
    dtype = graph.poses.dtype
    sqrt_info = graph.sqrt_information
    if sqrt_info is not None:
        sqrt_info = torch.cat([sqrt_info, sqrt_info[torch.as_tensor(donor, device=device)]])

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    corrupted = dataclasses.replace(
        graph,
        edges_ij=torch.cat([graph.edges_ij, torch.as_tensor(ij, dtype=torch.int32,
                                                            device=device)]),
        measurements=RigidTransform(torch.cat([graph.measurements.rotation, tensor(m_rot)]),
                                    torch.cat([graph.measurements.translation,
                                               tensor(m_trans)])),
        weights=torch.cat([graph.weights, graph.weights[torch.as_tensor(donor, device=device)]]),
        sqrt_information=sqrt_info,
    )
    is_outlier = np.concatenate([is_outlier, np.ones(n_inj, dtype=bool)])
    rob_new = np.concatenate([rob, np.ones(n_inj, dtype=bool)])
    return (corrupted, torch.as_tensor(is_outlier, device=device),
            torch.as_tensor(rob_new, device=device))


def classify_closures(weights, is_outlier, robust_edges, reject_below: float = 0.5) -> dict:
    """Precision and recall of outlier rejection from converged IRLS weights.

    An edge is rejected when its weight falls below ``reject_below``.
    Precision = rejected outliers / all rejected; recall = rejected
    outliers / all outliers; ``inliers_kept`` = true closures not rejected /
    all true closures.  An empty denominator reports 1.0.
    """
    w, out, rob = _host(weights), _host(is_outlier), _host(robust_edges)
    rejected = (w < reject_below) & rob
    tp = int(np.sum(rejected & out))
    n_rej = int(np.sum(rejected))
    n_out = int(np.sum(out))
    true_closures = rob & ~out
    kept = int(np.sum(true_closures & ~rejected))
    n_true = int(np.sum(true_closures))
    return {
        "precision": tp / n_rej if n_rej else 1.0,
        "recall": tp / n_out if n_out else 1.0,
        "inliers_kept": kept / n_true if n_true else 1.0,
        "n_rejected": n_rej,
        "n_outliers": n_out,
        "n_true_closures": n_true,
    }


def run_protocol(
    graph,
    rates=(0.1, 0.2, 0.3),
    modes=("random", "clustered"),
    kernels=("none", "huber", "cauchy", "welsch", "gnc_gm"),
    iterations: int = 30,
    solver: str = "auto",
    cg_iterations: int = 50,
    seed: int = 0,
    min_separation: int = 20,
    cluster_size: int = 8,
    robust_edges=None,
    reject_below: float = 0.5,
    scale_passes: int = 2,
    gnc_head: float = 0.0,
) -> list[dict]:
    """Run the injection matrix on ``graph``; one record per ``(mode, rate,
    kernel)``: the classification of :func:`classify_closures`,
    ``ate_vs_oracle`` (against the outlier-free L2 solve), the scale used
    and the final chi².  Robust rows go through
    :func:`~icp_tpu_torch.pose_graph.robust_solve` (``scale_passes``;
    ``gnc_head=0.0`` anneals from step 1, the multi-outlier GNC schedule).
    """
    from . import eval as ev

    if robust_edges is None:
        robust_edges = closure_mask(graph)
    oracle, _ = pose_graph.optimize(graph, iterations=iterations, solver=solver,
                                    cg_iterations=cg_iterations)
    oracle_t = _host(oracle.poses.translation)
    records: list[dict] = []
    for mode in modes:
        for rate in rates:
            bad, is_out, rob = inject_outliers(
                graph, rate, mode=mode, seed=seed, min_separation=min_separation,
                cluster_size=cluster_size, robust_edges=robust_edges)
            for kernel in kernels:
                if kernel == "none":
                    opt, costs = pose_graph.optimize(bad, iterations=iterations, solver=solver,
                                                     cg_iterations=cg_iterations)
                    scale, w = 0.0, None
                else:
                    opt, costs, scale, w = pose_graph.robust_solve(
                        bad, kernel=kernel, robust_edges=rob, iterations=iterations,
                        solver=solver, cg_iterations=cg_iterations, scale_passes=scale_passes,
                        gnc_head=gnc_head)
                rec = {
                    "mode": mode,
                    "rate": rate,
                    "kernel": kernel,
                    "scale_passes": scale_passes if kernel != "none" else 0,
                    "n_injected": int(_host(is_out).sum()),
                    "scale": float(scale),
                    "ate_vs_oracle": ev.ate(opt.poses.translation, oracle_t).rmse,
                    "chi2_final": float(costs[-1]),
                }
                if w is not None:
                    rec.update(classify_closures(w, is_out, rob, reject_below=reject_below))
                records.append(rec)
    return records
