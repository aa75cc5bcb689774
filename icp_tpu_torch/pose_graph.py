"""Pose-graph optimization back end (Gauss-Newton over SE(2)/SE(3)).

Port of :mod:`icp_tpu.pose_graph`.  Given keyframe poses and relative-pose
constraints (odometry chains and loop closures from re-registering keyframe
pairs), minimize

    sum_e  w_e * || log( Z_e^{-1} · X_i^{-1} · X_j ) ||^2

over the poses, with pose 0 gauge-fixed:

* the residuals of all edges evaluate in one batched pass (gathers, batched
  matmuls and the branch-free tangent maps of :mod:`icp_tpu_torch.lie`);
* the per-edge Jacobian blocks ``A_e = dr/d(delta_i)``, ``B_e =
  dr/d(delta_j)`` under the right perturbation ``X_k <- X_k · exp(delta_k)``
  come from forward-mode differentiation of the batched residual
  (``torch.func.jvp`` under ``vmap`` over the ``2·dof`` tangent directions),
  the JAX package's ``jacfwd`` under ``vmap``;
* the normal system solves **dense** (the whole-graph Jacobian assembled
  from the blocks, Jacobi-scaled, one ``linalg.solve_ex``), by **CG**
  (matrix-free on the blocks, ``jax.scipy.sparse.linalg.cg``'s recurrence
  and stopping rule) or by **block-Jacobi PCG** (batched einsums and
  ``index_add_`` scatters, O(E·dof²) per matvec);
* the fixed-budget GN loop is a Python loop with no host sync (the IRLS
  weights, the GNC schedule and the LM damping ramp stay on the device);
  the ``early_exit_tol`` loop reads its stop flag once per iteration.

One departure from the reference: the ``early_exit_tol`` loop tracks the
monotone guard's acceptance explicitly, where the JAX loop infers a rejected
step from the damping ramp (``icp_tpu/pose_graph.py:731``) and so stops on a
rejected step once the damping sits at its 1e3 clamp.

Edge sharding (:func:`shard_over_edges`): a rank keeps its block of the
edges and the whole poses, and the graph carries the process group
(``edge_group``).  Everything per edge is then local, and every reduction
over edges reduces over the group as well: the node sums of the scatters
(the right-hand sides, the PCG/CG matvecs and the block-Jacobi blocks), the
dense normal matrix, the cost sums, and the medians, quantiles and maxima
of the robust scale (over the gathered edge vector).  The JAX package let
XLA insert those reductions (one per ``segment_sum``).

Not ported: ``pad_nodes`` (it rounded node counts to buckets so that
refinements reused one compiled XLA executable; PyTorch compiles nothing per
shape).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from . import geometry, lie
from .geometry import RigidTransform
from .parallel.comm import all_gather, all_reduce
from .parallel.mesh import Layout, axis_group, axis_size, local_block, mesh_device

# torch.func.jvp keeps its forward-AD levels in process-wide state, so two
# threads linearizing at once (an asynchronous SLAM solve beside another
# solve) corrupt each other's levels: one linearization at a time.
_JVP_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Nodes ``poses`` (a batched transform, T nodes) and relative-pose edges.

    ``edges_ij (E, 2)`` int32 node indices; ``measurements`` the measured
    ``Z_e``, the frame-i-relative pose of frame j; ``weights (E,)`` scalar
    information weights.  ``sqrt_information`` (optional, ``(E, dof, dof)``):
    the per-edge whitener ``L^T`` with ``info = L L^T``
    (:func:`icp_tpu_torch.ops.covariance.sqrt_information`); residuals become
    ``sqrt(w_e) · L_e^T · log(...)``.  With matrix whitening on an edge, the
    robust kernels' geometric norm of that edge is the whitened norm divided
    by ``sqrt(w_e)``: pick ``robust_scale`` (or ``'auto'``) in those units.
    ``edge_group`` (set by :func:`shard_over_edges`): the process group
    whose ranks hold the other blocks of the edges; the edge fields are then
    this rank's block.
    """

    poses: RigidTransform  # (T, D, D) / (T, D)
    edges_ij: torch.Tensor  # (E, 2) int32
    measurements: RigidTransform  # (E, D, D) / (E, D)
    weights: torch.Tensor  # (E,)
    sqrt_information: torch.Tensor | None = None  # (E, dof, dof) or None
    edge_group: Any = None  # a torch.distributed process group, or None

    @property
    def num_nodes(self) -> int:
        return self.poses.translation.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edges_ij.shape[0]

    @property
    def dim(self) -> int:
        return self.poses.dim


def _endpoints(graph: PoseGraph) -> tuple[torch.Tensor, torch.Tensor]:
    ij = graph.edges_ij.long()
    return ij[:, 0], ij[:, 1]


def _gather(poses: RigidTransform, idx: torch.Tensor) -> RigidTransform:
    return RigidTransform(poses.rotation[idx], poses.translation[idx])


def _whiten(r: torch.Tensor, graph: PoseGraph, sqw: torch.Tensor) -> torch.Tensor:
    if graph.sqrt_information is not None:
        r = torch.matmul(graph.sqrt_information, r[..., None])[..., 0]
    return r * sqw[..., None]


def edge_residuals(graph: PoseGraph, poses: RigidTransform) -> torch.Tensor:
    """Weighted tangent residuals ``(E, dof)`` of all edges at once."""
    i, j = _endpoints(graph)
    rel = geometry.compose(geometry.inverse(_gather(poses, i)), _gather(poses, j))
    err = geometry.compose(geometry.inverse(graph.measurements), rel)
    return _whiten(lie.log(err), graph, torch.sqrt(graph.weights))


def _retract(poses: RigidTransform, delta: torch.Tensor, dim: int) -> RigidTransform:
    """Right-perturb every pose: ``X_k <- X_k · exp(delta_k)``."""
    return geometry.compose(poses, lie.exp(delta, dim))


def _residual_of_delta(graph: PoseGraph, delta_flat: torch.Tensor) -> torch.Tensor:
    """Flat residuals at the retracted poses; node 0 stays put (the gauge)."""
    delta = delta_flat.reshape(graph.num_nodes, lie.dof(graph.dim)).clone()
    delta[0] = 0.0
    return edge_residuals(graph, _retract(graph.poses, delta, graph.dim)).reshape(-1)


def _edge_linearization(
    graph: PoseGraph, poses: RigidTransform
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residuals and the per-edge Jacobian blocks in one batched pass.

    Returns ``(r (E, dof), A (E, dof, dof), B (E, dof, dof))`` with ``A =
    dr_e/d(delta_i)`` and ``B = dr_e/d(delta_j)``.  Each edge touches two
    nodes, so this is the complete Jacobian in O(E·dof²) storage.  The
    blocks are forward-mode derivatives of the residual along each of the
    ``2·dof`` tangent directions (one ``jvp``, vmapped over the directions),
    the computation of the JAX package's vmapped ``jacfwd``.
    """
    dim = graph.dim
    d = lie.dof(dim)
    i, j = _endpoints(graph)
    xi, xj = _gather(poses, i), _gather(poses, j)
    z_inv = geometry.inverse(graph.measurements)
    sqw = torch.sqrt(graph.weights)

    def res(dd):
        pi = geometry.compose(xi, lie.exp(dd[:, :d], dim))
        pj = geometry.compose(xj, lie.exp(dd[:, d:], dim))
        err = geometry.compose(z_inv, geometry.compose(geometry.inverse(pi), pj))
        return _whiten(lie.log(err), graph, sqw)

    e = graph.num_edges
    zero = torch.zeros((e, 2 * d), dtype=poses.dtype, device=poses.translation.device)
    basis = torch.eye(2 * d, dtype=zero.dtype, device=zero.device)[:, None, :].expand(
        2 * d, e, 2 * d)
    with _JVP_LOCK:
        r, cols = torch.func.vmap(lambda t: torch.func.jvp(res, (zero,), (t,)),
                                  out_dims=(None, 0))(basis)
    jac = cols.permute(1, 2, 0)  # (E, dof, 2 dof)
    return r, jac[..., :d], jac[..., d:]


ROBUST_KERNELS = ("none", "huber", "cauchy", "welsch", "gnc_gm")


def _check_kernel(kernel: str) -> None:
    if kernel not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel {kernel!r}; one of {ROBUST_KERNELS}")


def _robust_weights(rn2: torch.Tensor, kernel: str, scale, mu) -> torch.Tensor:
    """IRLS weight per edge from the squared geometric residual norm.

    ``rn2`` is ``||log(Z^-1 X_i^-1 X_j)||^2`` before information weighting,
    so ``scale`` is in plain residual units (meters and radians), not chi²:
    the inlier threshold does not shrink with an edge's information weight.
    ``mu`` is the GNC control parameter (ignored by the fixed-scale kernels).
    """
    _check_kernel(kernel)
    c2 = scale * scale
    if kernel == "none":
        return torch.ones_like(rn2)
    if kernel == "huber":
        rn = torch.sqrt(rn2 + torch.finfo(rn2.dtype).tiny)
        return torch.clamp(scale / rn, max=1.0)
    if kernel == "cauchy":
        return 1.0 / (1.0 + rn2 / c2)
    if kernel == "welsch":
        return torch.exp(-rn2 / c2)
    # Geman-McClure surrogate at control mu: mu -> inf is quadratic, mu = 1
    # the true GM kernel.  w = (mu c^2 / (r^2 + mu c^2))^2.
    return torch.square(mu * c2 / (rn2 + mu * c2))


def _robust_rho(rn2: torch.Tensor, kernel: str, scale, mu) -> torch.Tensor:
    """Robust cost per edge (the quantity the IRLS weights descend)."""
    _check_kernel(kernel)
    c2 = scale * scale
    if kernel == "none":
        return rn2
    if kernel == "huber":
        rn = torch.sqrt(rn2 + torch.finfo(rn2.dtype).tiny)
        return torch.where(rn <= scale, rn2, 2.0 * scale * rn - c2)
    if kernel == "cauchy":
        return c2 * torch.log1p(rn2 / c2)
    if kernel == "welsch":
        return c2 * (1.0 - torch.exp(-rn2 / c2))
    return mu * c2 * rn2 / (rn2 + mu * c2)


def _masked(values: torch.Tensor, mask: torch.Tensor | None, other) -> torch.Tensor:
    if mask is None:
        return values
    return torch.where(mask, values, other)


def robust_edge_weights(
    graph: PoseGraph,
    robust: str,
    robust_scale,
    mu: float = 1.0,
    robust_edges: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Final IRLS weights ``(E,)`` and geometric residual norms ``(E,)`` at
    ``graph.poses``.

    Call it after :func:`optimize` with the same ``robust_edges`` mask to
    classify edges: a converged GNC/Welsch solve drives outlier closures'
    weights to ~0 while inliers stay near 1.  The norms are unwhitened
    (meters and radians), the units of ``robust_scale``.
    """
    rn2 = _geometric_rn2(graph, graph.poses)
    mu_t = torch.as_tensor(mu, dtype=rn2.dtype, device=rn2.device)
    w = _masked(_robust_weights(rn2, robust, robust_scale, mu_t), robust_edges,
                torch.ones_like(rn2))
    return w, torch.sqrt(rn2)


def _edge_sum(values: torch.Tensor, group) -> torch.Tensor:
    """The sum over the edges: this rank's block, then the edge group's."""
    total = values.sum()
    return total if group is None else all_reduce(total.reshape(1), group)[0]


def _edge_max(values: torch.Tensor, group) -> torch.Tensor:
    total = values.max()
    return total if group is None else all_reduce(total.reshape(1), group, "max")[0]


def _all_edges(values: torch.Tensor, group) -> torch.Tensor:
    """The whole edge vector: every rank's block in rank order."""
    return values if group is None else all_gather(values, group)


def _index(values: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """``values[position]`` for a 0-d index tensor, without a host sync."""
    return values.index_select(0, position.reshape(1).long())[0]


def _masked_upper_median(rn: torch.Tensor, keep: torch.Tensor, group=None) -> torch.Tensor:
    """Upper median of ``rn`` over ``keep`` (0 if the mask is empty), over
    every block of an edge ``group``."""
    rn, keep = _all_edges(rn, group), _all_edges(keep, group)
    vals = torch.sort(torch.where(keep, rn, torch.full_like(rn, torch.inf))).values
    count = keep.sum()
    v = _index(vals, torch.clamp(count // 2, min=0))
    return torch.where(count > 0, v, torch.zeros_like(v))


def _masked_quantile(rn: torch.Tensor, keep: torch.Tensor, q: float, group=None) -> torch.Tensor:
    """Masked quantile with ``np.quantile``'s linear interpolation (0 if the
    mask is empty): the device twin of :func:`robust_solve`'s host
    bootstrap floor."""
    rn, keep = _all_edges(rn, group), _all_edges(keep, group)
    vals = torch.sort(torch.where(keep, rn, torch.full_like(rn, torch.inf))).values
    count = keep.sum()
    last = torch.clamp(count - 1, min=0)
    pos = q * last.to(rn.dtype)
    lo = torch.floor(pos).long()
    hi = torch.minimum(lo + 1, last)
    frac = pos - lo.to(rn.dtype)
    v = _index(vals, lo) * (1.0 - frac) + _index(vals, hi) * frac
    return torch.where(count > 0, v, torch.zeros_like(v))


def _noise_and_robust_masks(graph: PoseGraph, robust_edges):
    live = graph.weights > 0
    if robust_edges is None:
        return live, live
    return robust_edges & live, (~robust_edges) & live


def auto_robust_scale(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str = "auto",
    cg_iterations: int = 50,
    robust_edges: torch.Tensor | None = None,
    rule: str = "median",
    early_exit_tol: float | None = None,
) -> torch.Tensor:
    """Data-driven robust inlier scale from an L2 pre-solve (a 0-d tensor).

    ``rule='median'`` (default): ``2 · upper-median robust-edge residual``
    at the L2 solution; ``rule='max'`` is the legacy ``2 · max`` rule (it
    keys to the worst outlier and breaks under several outliers of
    different magnitude).  Floored by half the upper-median residual of the
    non-robust (odometry) edges, the graph's ambient noise, and by 1e-3.
    """
    if rule not in ("median", "max"):
        raise ValueError(f"unknown auto-scale rule {rule!r}; 'median' or 'max'")
    base, _ = optimize(graph, iterations=iterations, damping=damping, solver=solver,
                       cg_iterations=cg_iterations, early_exit_tol=early_exit_tol)
    rn = torch.sqrt(_geometric_rn2(base, base.poses))
    keep_rob, keep_noise = _noise_and_robust_masks(graph, robust_edges)
    group = graph.edge_group
    if rule == "max":
        closure_stat = _edge_max(torch.where(keep_rob, rn, torch.zeros_like(rn)), group)
    else:
        closure_stat = _masked_upper_median(rn, keep_rob, group)
    noise = _masked_upper_median(rn, keep_noise, group)
    return torch.clamp(torch.maximum(2.0 * closure_stat, 0.5 * noise), min=1e-3)


def _geometric_rn2(graph: PoseGraph, poses: RigidTransform) -> torch.Tensor:
    """Squared unwhitened residual norms ``(E,)`` (zero-weight safe)."""
    r = edge_residuals(graph, poses)
    return _unwhiten((r * r).sum(-1), graph.weights)


def _unwhiten(rn2_whitened: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """chi² -> squared geometric norm; zero-weight (padding) edges -> 0."""
    live = weights > 0
    safe = torch.where(live, weights, torch.ones_like(weights))
    return torch.where(live, rn2_whitened / safe, torch.zeros_like(rn2_whitened))


def _scatter(num_nodes: int, i, j, vi, vj, group=None) -> torch.Tensor:
    """Per-node sums of the edges' contributions to their two endpoints (of
    every block of an edge ``group``)."""
    out = torch.zeros((num_nodes,) + tuple(vi.shape[1:]), dtype=vi.dtype, device=vi.device)
    out.index_add_(0, i, vi)
    out.index_add_(0, j, vj)
    return out if group is None else all_reduce(out, group)


def _tmatvec(blocks: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``blocks^T v`` per edge: ``(E, d, d), (E, d) -> (E, d)``."""
    return torch.matmul(v[:, None, :], blocks)[:, 0]


def _matvec(blocks: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.matmul(blocks, v[..., None])[..., 0]


def _jt(a_blk, b_blk, i, j, num_nodes, u, group=None) -> torch.Tensor:
    """``J^T u`` with node 0's rows zeroed (the gauge)."""
    g = _scatter(num_nodes, i, j, _tmatvec(a_blk, u), _tmatvec(b_blk, u), group)
    g[0] = 0.0
    return g


def _j(a_blk, b_blk, i, j, v) -> torch.Tensor:
    """``J v`` per edge, node 0's update held at zero."""
    vz = v.clone()
    vz[0] = 0.0
    return _matvec(a_blk, vz[i]) + _matvec(b_blk, vz[j])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum()


def _pcg_delta(r, a_blk, b_blk, i, j, num_nodes: int, damping, iterations: int,
               group=None) -> torch.Tensor:
    """Block-Jacobi PCG solve of ``(P Jᵀ J P + λI) delta = -P Jᵀ r``.

    ``P`` projects out node 0 (the gauge); the Krylov space stays in the
    node-0-free subspace because the right-hand side and the preconditioner
    both vanish there.  A fixed ``iterations`` budget with no host sync;
    a zero denominator freezes the iterate, as in the JAX package.
    """
    d = r.shape[-1]
    rhs = -_jt(a_blk, b_blk, i, j, num_nodes, r, group)

    def hv(v):
        vz = v.clone()
        vz[0] = 0.0
        return _jt(a_blk, b_blk, i, j, num_nodes, _j(a_blk, b_blk, i, j, vz), group) + damping * vz

    blocks = _scatter(num_nodes, i, j, torch.matmul(a_blk.transpose(-1, -2), a_blk),
                      torch.matmul(b_blk.transpose(-1, -2), b_blk), group)
    blocks = blocks + damping * torch.eye(d, dtype=r.dtype, device=r.device)
    minv = torch.linalg.inv_ex(blocks).inverse

    x = torch.zeros_like(rhs)
    res = rhs
    z = _matvec(minv, res)
    p = z
    rz = _dot(res, z)
    for _ in range(iterations):
        hp = hv(p)
        denom = _dot(p, hp)
        zero_denom = denom == 0
        alpha = torch.where(zero_denom, torch.zeros_like(rz),
                            rz / torch.where(zero_denom, torch.ones_like(denom), denom))
        x = x + alpha * p
        res = res - alpha * hp
        z = _matvec(minv, res)
        rz_new = _dot(res, z)
        zero_rz = rz == 0
        beta = torch.where(zero_rz, torch.zeros_like(rz),
                           rz_new / torch.where(zero_rz, torch.ones_like(rz), rz))
        p = p * beta + z
        rz = rz_new
    return x


def _cg_delta(a_blk, b_blk, i, j, num_nodes: int, wr0, damping, iterations: int, group=None):
    """Unpreconditioned CG on ``(Jᵀ J + λI) delta = -Jᵀ r`` from ``x0 = 0``:
    the recurrence and stopping rule of ``jax.scipy.sparse.linalg.cg`` as the
    JAX package calls it (``tol = 1e-5``, ``atol = 0``: stop once ``|r|² <=
    tol²·|b|²``, or after ``iterations`` steps).  The stop is applied as a
    mask, so the loop runs its whole budget without a host sync and returns
    the iterate of the step where JAX's ``while_loop`` would have stopped."""

    def a_op(v):
        return _jt(a_blk, b_blk, i, j, num_nodes, _j(a_blk, b_blk, i, j, v), group) + damping * v

    b = -_jt(a_blk, b_blk, i, j, num_nodes, wr0, group)
    atol2 = torch.clamp(1e-5 ** 2 * _dot(b, b), min=0.0)
    x = torch.zeros_like(b)
    r = b - a_op(x)
    p = r
    gamma = _dot(r, r)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(iterations):
        done = done | ~(gamma > atol2)
        ap = a_op(p)
        alpha = gamma / _dot(p, ap)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        gamma_new = _dot(r_new, r_new)
        p_new = r_new + (gamma_new / gamma) * p
        x = torch.where(done, x, x_new)
        r = torch.where(done, r, r_new)
        p = torch.where(done, p, p_new)
        gamma = torch.where(done, gamma, gamma_new)
    return x


def _dense_delta(a_blk, b_blk, i, j, num_nodes: int, wr0, damping, group=None) -> torch.Tensor:
    """Dense GN step on the whole-graph Jacobian ``(E·dof, T·dof)``.

    Jacobi (diagonal) scaling comes before the factorization: a no-op in
    exact arithmetic, but in float32 the raw normal matrix mixes edge
    weights (~1e2), unit blocks and bare damping (1e-6 on edge-less nodes),
    condition numbers past float32's LU range (the JAX package measured the
    unscaled solve diverging to NaN on its first step).
    """
    e, d = wr0.shape
    n_var = num_nodes * d
    rows = torch.arange(e, device=wr0.device)
    jac = torch.zeros((e, num_nodes, d, d), dtype=wr0.dtype, device=wr0.device)
    jac.index_put_((rows, i), a_blk, accumulate=True)
    jac.index_put_((rows, j), b_blk, accumulate=True)
    jac[:, 0] = 0.0  # the gauge: node 0's columns
    jac = jac.permute(0, 2, 1, 3).reshape(e * d, n_var)
    jtj = torch.matmul(jac.T, jac)
    jtr = torch.matmul(jac.T, wr0.reshape(-1))
    if group is not None:
        jtj, jtr = all_reduce(jtj, group), all_reduce(jtr, group)
    jtj = jtj + damping * torch.eye(n_var, dtype=wr0.dtype, device=wr0.device)
    dj = torch.sqrt(torch.diagonal(jtj))
    s = 1.0 / torch.clamp(dj, min=torch.finfo(wr0.dtype).tiny ** 0.5)
    jtj_s = jtj * s[:, None] * s[None, :]
    return -s * torch.linalg.solve_ex(jtj_s, jtr * s).result


def optimize(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    solver: str = "auto",
    cg_iterations: int = 50,
    robust: str = "none",
    robust_scale="auto",
    robust_edges: torch.Tensor | None = None,
    gnc_head: float = 0.25,
    early_exit_tol: float | None = None,
) -> tuple[PoseGraph, torch.Tensor]:
    """Run Gauss-Newton / IRLS; returns (optimized graph, per-iteration cost).

    ``solver``: ``'dense'`` (the whole-graph Jacobian; fine to a few hundred
    variables), ``'cg'`` (matrix-free CG on the normal equations), ``'pcg'``
    (block-Jacobi PCG on the per-edge blocks, the scalable path) or
    ``'auto'`` (dense up to 512 variables, else pcg).

    ``robust`` selects a per-edge kernel applied by IRLS: each iteration
    weights its residuals and Jacobians by ``sqrt(w_e)`` from the current
    geometric residual norms.  ``'huber'``, ``'cauchy'``, ``'welsch'`` are
    fixed-scale; ``'gnc_gm'`` is graduated non-convexity on Geman-McClure
    under a three-phase schedule: a quadratic head (``gnc_head`` of the
    budget; 0 starts the anneal at step 1), a geometric anneal of mu from
    ``2·max r²/c²`` down to 1, and a tail (a quarter of the budget) at mu =
    1.  Give it ``iterations >= 30``.  ``robust_scale`` is the inlier
    threshold in plain residual units, or ``'auto'``
    (:func:`auto_robust_scale`, one extra L2 solve).  ``robust_edges`` (bool
    ``(E,)``) restricts the kernel to those edges (pass the loop closures:
    a redescending kernel on odometry edges can disconnect the chain).

    With a robust kernel each step passes a monotone guard: a step that
    raises the robust cost (at the same mu) is rejected, and the LM damping
    goes up 8x on a rejection and down 2x on an acceptance, within
    ``[damping, 1e3]``.

    The cost trace is ``sum_e w_e · rho(||r_e||)`` before each step and
    after the last one (``iterations + 1`` entries).  ``early_exit_tol``
    (fixed-scale kernels and L2 only) stops once a step improves the cost by
    less than ``tol`` relative and the step just taken was accepted; the
    trace then holds the initial and the final cost.
    """
    _check_kernel(robust)
    if isinstance(robust_scale, str):
        if robust_scale != "auto":
            raise ValueError(f"robust_scale must be a float or 'auto', got {robust_scale!r}")
        if robust != "none":
            robust_scale = auto_robust_scale(graph, iterations=iterations, damping=damping,
                                             solver=solver, cg_iterations=cg_iterations,
                                             robust_edges=robust_edges)
        else:
            robust_scale = 1.0
    dim = graph.dim
    d = lie.dof(dim)
    n_var = graph.num_nodes * d
    if solver == "auto":
        solver = "dense" if n_var <= 512 else "pcg"
    if solver not in ("dense", "cg", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    if early_exit_tol is not None and robust == "gnc_gm":
        raise ValueError("early_exit_tol does not support the gnc_gm schedule "
                         "(fixed-length mu anneal)")
    dtype = graph.poses.dtype
    device = graph.poses.translation.device
    group = graph.edge_group
    i, j = _endpoints(graph)

    def weights_of(rn2, mu):
        return _masked(_robust_weights(rn2, robust, robust_scale, mu), robust_edges,
                       torch.ones_like(rn2))

    def rho_of(rn2, mu):
        return _masked(_robust_rho(rn2, robust, robust_scale, mu), robust_edges, rn2)

    def cost_at(poses, mu):
        g = dataclasses.replace(graph, poses=poses)
        return _edge_sum(graph.weights * rho_of(_geometric_rn2(g, poses), mu), group)

    if robust == "gnc_gm":
        rn2_init = _masked(_geometric_rn2(graph, graph.poses), robust_edges,
                           torch.zeros((), dtype=dtype, device=device))
        c2 = robust_scale * robust_scale
        mu0 = torch.clamp(2.0 * _edge_max(rn2_init, group) / c2, min=1.0)
        head = max(1, int(iterations * gnc_head)) if gnc_head > 0 else 0
        tail = max(1, iterations // 4)
        anneal = max(1, iterations - head - tail)
        k = torch.arange(iterations, dtype=dtype, device=device)
        frac = torch.clamp((k - max(head - 1, 0)) / float(anneal), 0.0, 1.0)
        mus = torch.where(k < head, torch.full_like(k, 1e12), mu0 ** (1.0 - frac))
    else:
        mus = torch.ones((iterations,), dtype=dtype, device=device)

    def gn_step(poses, lm, mu):
        """One step: (new poses, new damping, cost before it, accepted)."""
        g = dataclasses.replace(graph, poses=poses)
        r_e, a_blk, b_blk = _edge_linearization(g, poses)
        if solver != "pcg":
            # The JAX package's dense and CG paths take the residuals from a
            # plain evaluation, the monotone guard's own; PCG from the
            # linearization.  The guard compares costs at roundoff near
            # convergence, so each path keeps its source.
            r_e = edge_residuals(g, poses)
        rn2 = _unwhiten((r_e * r_e).sum(-1), graph.weights)
        cost = _edge_sum(graph.weights * rho_of(rn2, mu), group)
        sw = torch.sqrt(weights_of(rn2, mu))
        r_e = r_e * sw[:, None]
        a_blk = a_blk * sw[:, None, None]
        b_blk = b_blk * sw[:, None, None]
        if solver == "pcg":
            delta = _pcg_delta(r_e, a_blk, b_blk, i, j, graph.num_nodes, lm, cg_iterations,
                               group)
        elif solver == "cg":
            delta = _cg_delta(a_blk, b_blk, i, j, graph.num_nodes, r_e, lm, cg_iterations, group)
        else:
            delta = _dense_delta(a_blk, b_blk, i, j, graph.num_nodes, r_e, lm, group)
        delta = delta.reshape(graph.num_nodes, d).clone()
        delta[0] = 0.0
        new_poses = _retract(poses, delta, dim)
        if robust == "none":
            return new_poses, lm, cost, torch.ones((), dtype=torch.bool, device=device)
        # Monotone-descent guard (majorization-minimization): the IRLS
        # weights majorize the robust cost, so a step that raises the true
        # robust cost at the same mu is a linearization artifact; reject it
        # and raise the damping (the LM trust-region ramp).
        accept = cost_at(new_poses, mu) <= cost
        new_poses = RigidTransform(
            torch.where(accept, new_poses.rotation, poses.rotation),
            torch.where(accept, new_poses.translation, poses.translation))
        new_lm = torch.where(accept, torch.clamp(lm * 0.5, min=damping),
                             torch.clamp(lm * 8.0, max=1e3))
        return new_poses, new_lm, cost, accept

    poses = graph.poses
    lm = torch.tensor(damping, dtype=dtype, device=device)
    if early_exit_tol is not None:
        mu1 = torch.ones((), dtype=dtype, device=device)
        prev_cost = torch.tensor(torch.inf, dtype=dtype, device=device)
        for _ in range(iterations):
            poses, lm, cost, accept = gn_step(poses, lm, mu1)
            # ``cost`` is evaluated before the step, so prev_cost - cost is
            # the previous step's improvement; the stop also needs the step
            # just taken to be accepted (a rejected one leaves the poses
            # unchanged while the damping adapts).
            stop = accept & (prev_cost - cost <= early_exit_tol * torch.clamp(cost, min=1e-30))
            prev_cost = cost
            if bool(stop):
                break
        costs = torch.stack([cost_at(graph.poses, mu1), cost_at(poses, mu1)])
        return dataclasses.replace(graph, poses=poses), costs

    costs = []
    for k in range(iterations):
        poses, lm, cost, _ = gn_step(poses, lm, mus[k])
        costs.append(cost)
    mu_final = mus[-1] if iterations > 0 else torch.ones((), dtype=dtype, device=device)
    costs.append(cost_at(poses, mu_final))
    return dataclasses.replace(graph, poses=poses), torch.stack(costs)


def robust_solve(
    graph: PoseGraph,
    kernel: str = "welsch",
    robust_edges: torch.Tensor | None = None,
    iterations: int = 30,
    solver: str = "auto",
    cg_iterations: int = 50,
    damping: float = 1e-6,
    robust_scale="auto",
    scale_passes: int = 2,
    shrink_bound: float = 8.0,
    gnc_head: float = 0.25,
) -> tuple[PoseGraph, torch.Tensor, float, torch.Tensor]:
    """Multi-outlier robust solve: auto scale and bounded re-estimation.
    Returns ``(optimized graph, costs, scale, weights)``.

    Solve at the pass-1 scale, re-estimate the scale from the residuals at
    the robust solution (``2 ·`` upper median of the closures, ``0.5 ·`` that
    of the odometry edges), and re-solve cold from ``graph.poses``.  Two
    floors keep the re-estimate from collapsing: the lower-quartile closure
    residual at the initial poses (so the nearest closures keep enough
    weight to bootstrap a redescending kernel) and ``scale / shrink_bound``
    per pass.  The statistics are host numpy, one sync per pass.
    ``scale_passes=2`` is the validated default on the Manhattan protocol.
    """
    if isinstance(robust_scale, str):
        if robust_scale != "auto":
            raise ValueError(f"robust_scale must be a float or 'auto', got {robust_scale!r}")
        scale = float(auto_robust_scale(graph, iterations=iterations, damping=damping,
                                        solver=solver, cg_iterations=cg_iterations,
                                        robust_edges=robust_edges))
    else:
        scale = float(robust_scale)

    def solve(s):
        return optimize(graph, iterations=iterations, damping=damping, solver=solver,
                        cg_iterations=cg_iterations, robust=kernel, robust_scale=s,
                        robust_edges=robust_edges, gnc_head=gnc_head)

    def host(x):
        # The whole edge vector, also of an edge-sharded graph.
        return _all_edges(x, graph.edge_group).detach().cpu().numpy()

    live = host(graph.weights) > 0
    if robust_edges is not None:
        mask = host(robust_edges)
        rob, noise_mask = mask & live, ~mask & live
    else:
        rob = noise_mask = live
    rn_init = np.sqrt(host(_geometric_rn2(graph, graph.poses)))
    bootstrap = float(np.quantile(rn_init[rob], 0.25)) if rob.any() else 0.0

    opt, costs = solve(scale)
    for _ in range(max(0, scale_passes - 1)):
        rn = np.sqrt(host(_geometric_rn2(opt, opt.poses)))
        vals = np.sort(rn[rob])
        clo = vals[len(vals) // 2] if len(vals) else 0.0
        nvals = np.sort(rn[noise_mask])
        noise = nvals[len(nvals) // 2] if len(nvals) else 0.0
        new_scale = max(2.0 * clo, 0.5 * noise, bootstrap, scale / shrink_bound, 1e-3)
        if abs(new_scale - scale) <= 1e-9 * scale:
            break
        scale = float(new_scale)
        opt, costs = solve(scale)
    weights, _ = robust_edge_weights(opt, kernel, scale, robust_edges=robust_edges)
    return opt, costs, scale, weights


def robust_solve_fused(
    graph: PoseGraph,
    robust_edges: torch.Tensor | None = None,
    kernel: str = "welsch",
    iterations: int = 30,
    solver: str = "auto",
    cg_iterations: int = 50,
    damping: float = 1e-6,
    robust_scale="auto",
    scale_passes: int = 2,
    shrink_bound: float = 8.0,
    gnc_head: float = 0.25,
    early_exit_tol: float | None = None,
) -> tuple[PoseGraph, torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`robust_solve` with every statistic on the device.

    The same recipe, but the medians and the bootstrap quartile are masked
    device reductions (:func:`_masked_upper_median`, :func:`_masked_quantile`)
    and the pass count is fixed (no early break on an unchanged scale: a
    re-solve at the same scale from the same cold start gives the same
    result).  Returns ``(optimized graph, costs, scale, weights)`` with
    ``scale`` a 0-d tensor.
    """
    dtype = graph.poses.dtype
    device = graph.poses.translation.device
    if isinstance(robust_scale, str):
        if robust_scale != "auto":
            raise ValueError(f"robust_scale must be a float or 'auto', got {robust_scale!r}")
        scale = auto_robust_scale(graph, iterations=iterations, damping=damping,
                                  solver=solver, cg_iterations=cg_iterations,
                                  robust_edges=robust_edges, early_exit_tol=early_exit_tol)
    else:
        scale = torch.as_tensor(robust_scale, dtype=dtype, device=device)
    rob, noise_mask = _noise_and_robust_masks(graph, robust_edges)
    group = graph.edge_group
    bootstrap = _masked_quantile(torch.sqrt(_geometric_rn2(graph, graph.poses)), rob, 0.25, group)

    def solve(s):
        return optimize(graph, iterations=iterations, damping=damping, solver=solver,
                        cg_iterations=cg_iterations, robust=kernel, robust_scale=s,
                        robust_edges=robust_edges, gnc_head=gnc_head,
                        early_exit_tol=early_exit_tol)

    opt, costs = solve(scale)
    for _ in range(max(0, scale_passes - 1)):
        rn = torch.sqrt(_geometric_rn2(opt, opt.poses))
        clo = _masked_upper_median(rn, rob, group)
        noise = _masked_upper_median(rn, noise_mask, group)
        scale = torch.maximum(
            torch.maximum(torch.maximum(2.0 * clo, 0.5 * noise), bootstrap),
            torch.clamp(scale / shrink_bound, min=1e-3),
        )
        opt, costs = solve(scale)
    weights, _ = robust_edge_weights(opt, kernel, scale, robust_edges=robust_edges)
    return opt, costs, scale, weights


def _candidate_mask(poses: RigidTransform, radius: float, min_separation: int, exclude):
    """Pose distances ``(T, T)`` and the valid-pair mask: ``j - i >=
    min_separation`` (so ``j > i``), distance ``< radius``, not excluded."""
    t = poses.translation
    n = t.shape[0]
    diff = t[:, None, :] - t[None, :, :]
    dist = torch.sqrt((diff * diff).sum(-1))
    idx = torch.arange(n, device=t.device)
    ok = (dist < radius) & ((idx[None, :] - idx[:, None]) >= min_separation)
    if exclude is not None:
        ok = ok & ~exclude
    return dist, ok


def find_loop_candidates_topk(
    poses: RigidTransform,
    radius: float,
    min_separation: int = 10,
    k: int = 64,
    exclude: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Loop candidates at a fixed size: the up-to-``k`` closest pairs.

    Returns ``(pairs (k', 2) int32, valid (k',) bool)`` with ``k' = min(k,
    T²)``: the pairs with ``j - i >= min_separation`` and distance <
    ``radius`` first, by ascending distance, ties by row-major pair order (a
    stable sort of the masked distance matrix; ``top_k``'s tie order is not
    guaranteed).  ``exclude`` (bool ``(T, T)``) drops pairs before the
    truncation, so that tried pairs cannot starve fresh ones.
    """
    dist, ok = _candidate_mask(poses, radius, min_separation, exclude)
    n = dist.shape[0]
    masked = torch.where(ok, dist, torch.full_like(dist, torch.inf)).reshape(-1)
    vals, order = torch.sort(masked, stable=True)
    kk = min(k, n * n)
    order = order[:kk]
    pairs = torch.stack([order // n, order % n], dim=-1).to(torch.int32)
    return pairs, torch.isfinite(vals[:kk])


def _count_loop_candidates(
    poses: RigidTransform, radius: float, min_separation: int, exclude=None
) -> torch.Tensor:
    """Exact count of valid loop-candidate pairs (one O(T²) reduction)."""
    return _candidate_mask(poses, radius, min_separation, exclude)[1].sum()


def find_loop_candidates(
    poses: RigidTransform,
    radius: float,
    min_separation: int = 10,
    max_candidates: int | None = None,
    exclude: torch.Tensor | None = None,
) -> torch.Tensor:
    """Candidate loop-closure pairs ``(K, 2)`` int32: trajectory indices
    whose poses are within ``radius`` but at least ``min_separation`` steps
    apart, by ascending distance; ``max_candidates`` truncates.

    Without ``max_candidates`` the search is sized to the exact valid count
    (one host sync; the JAX package rounded it up to a power of two only to
    share compiled executables).  The compaction of the validity mask is a
    second sync, as in JAX.
    """
    n = poses.translation.shape[0]
    if max_candidates is not None:
        budget = max_candidates
    else:
        budget = max(1, int(_count_loop_candidates(poses, radius, min_separation, exclude)))
    pairs, valid = find_loop_candidates_topk(poses, radius, min_separation=min_separation,
                                             k=min(budget, n * n), exclude=exclude)
    return pairs[valid]


def pad_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge list to a multiple of ``multiple`` with zero-weight
    ``(0, 0)`` self-edges (identity measurements).

    Zero weight scales the padded residuals and their Jacobian blocks to
    exactly 0, so padding never perturbs the solve.
    """
    e = graph.num_edges
    pad = (-e) % multiple
    if pad == 0:
        return graph
    dim = graph.dim
    dtype = graph.poses.dtype
    device = graph.poses.translation.device
    eye = torch.eye(dim, dtype=dtype, device=device).expand(pad, dim, dim)
    sqrt_info = graph.sqrt_information
    if sqrt_info is not None:
        d = lie.dof(dim)
        sqrt_info = torch.cat([sqrt_info, torch.eye(d, dtype=dtype, device=device).expand(
            pad, d, d)])
    return dataclasses.replace(
        graph,
        edges_ij=torch.cat([graph.edges_ij, torch.zeros((pad, 2), dtype=graph.edges_ij.dtype,
                                                        device=device)]),
        measurements=RigidTransform(
            torch.cat([graph.measurements.rotation, eye]),
            torch.cat([graph.measurements.translation,
                       torch.zeros((pad, dim), dtype=dtype, device=device)]),
        ),
        weights=torch.cat([graph.weights, torch.zeros((pad,), dtype=dtype, device=device)]),
        sqrt_information=sqrt_info,
    )


def shard_over_edges(graph: PoseGraph, mesh, axis: str = "data") -> PoseGraph:
    """This rank's block of the edges over ``mesh``'s ``axis``, the poses
    whole, and the axis' process group as ``edge_group``.

    :func:`optimize` (every solver and robust kernel) then linearizes this
    rank's edges and reduces every edge sum over the group (module doc);
    every rank gets the same poses and costs.  The edge count is padded to
    the axis size first (:func:`pad_edges`); zero-weight padding is exact.
    Per-edge inputs and outputs (``robust_edges``, the weights of
    :func:`robust_edge_weights`) are this rank's block.
    """
    graph = pad_edges(graph, axis_size(mesh, axis))
    edges = Layout(mesh, (axis,))
    device = mesh_device(mesh)
    return PoseGraph(
        poses=RigidTransform(graph.poses.rotation.to(device), graph.poses.translation.to(device)),
        edges_ij=local_block(graph.edges_ij, edges),
        measurements=RigidTransform(local_block(graph.measurements.rotation, edges),
                                    local_block(graph.measurements.translation, edges)),
        weights=local_block(graph.weights, edges),
        sqrt_information=(None if graph.sqrt_information is None
                          else local_block(graph.sqrt_information, edges)),
        edge_group=axis_group(mesh, axis),
    )


def register_loop_closures(
    clouds,
    poses: RigidTransform,
    candidates,
    method,
    driver_config,
    max_cost: float | None = None,
    coarse: bool = False,
    guesses: RigidTransform | None = None,
    converge_fn=None,
):
    """Register every candidate pair in one batched ``converge`` and return
    the accepted ``(edges (K', 2) int32, measurements, costs)``.

    ``clouds`` is the keyframe cloud stack ``(T, N, D)`` aligned with
    ``poses``.  The seed of pair ``(i, j)`` is ``X_i^{-1} X_j`` from the
    current poses; ``coarse=True`` seeds with the global initializer
    (``ops.coarse``) instead, for drift beyond ICP's basin; ``guesses`` (a
    ``(K,)``-batched transform aligned with ``candidates``) overrides both.
    ``converge_fn`` (``(source, target, guess) -> (result, state)``)
    replaces :func:`icp_tpu_torch.driver.converge`.  ``max_cost`` drops
    closures whose converged cost exceeds it (one host sync).
    """
    from .cloud import PointCloud
    from .driver import converge

    device = poses.translation.device
    if isinstance(candidates, torch.Tensor):
        cand_np = candidates.detach().cpu().numpy()
    else:
        cand_np = np.asarray(candidates)
    cand_np = cand_np.reshape(-1, 2)
    if cand_np.size == 0:
        dim = poses.dim
        empty = RigidTransform(torch.zeros((0, dim, dim), dtype=poses.dtype, device=device),
                               torch.zeros((0, dim), dtype=poses.dtype, device=device))
        return (torch.zeros((0, 2), dtype=torch.int32, device=device), empty,
                torch.zeros((0,), dtype=poses.dtype, device=device))
    cand = torch.as_tensor(cand_np, dtype=torch.int32, device=device)
    i, j = cand[:, 0].long(), cand[:, 1].long()
    src = PointCloud(clouds.points[j], clouds.count[j])
    tgt = PointCloud(clouds.points[i], clouds.count[i])
    if guesses is not None:
        seed = guesses
    elif coarse:
        from .ops.coarse import coarse_align_2d, coarse_align_3d

        seed = (coarse_align_2d if poses.dim == 2 else coarse_align_3d)(src, tgt)
    else:
        seed = geometry.compose(geometry.inverse(_gather(poses, i)), _gather(poses, j))
    if converge_fn is not None:
        result, _ = converge_fn(src, tgt, seed)
    else:
        result, _ = converge(method, src, tgt, seed, driver_config)
    # Z_e, the frame-i pose of frame j: registering j onto i gives exactly it.
    meas = result.transform
    if max_cost is not None:
        good = result.cost <= max_cost
        keep = torch.nonzero(good).reshape(-1)
        return (cand[keep], _gather(meas, keep), result.cost[keep])
    return cand, meas, result.cost


def graph_from_trajectory(
    poses: RigidTransform,
    odometry_measurements: RigidTransform,
    loop_edges: torch.Tensor | None = None,
    loop_measurements: RigidTransform | None = None,
    odometry_weight=1.0,
    loop_weight=1.0,
    loop_information: torch.Tensor | None = None,
) -> PoseGraph:
    """Assemble a graph: consecutive odometry edges, then the loop closures.

    ``odometry_measurements`` are frame-t-relative poses of frame t+1
    (length T-1); loop edges and measurements likewise frame-i-relative of
    j.  ``odometry_weight`` / ``loop_weight`` are scalars or per-edge
    tensors (zero-weight padding edges are exactly inert).
    ``loop_information`` (``(K, dof, dof)``, optional): per-closure
    information matrices, whitened into the residuals through their
    Cholesky factors; odometry edges get identity blocks.
    """
    t = poses.translation.shape[0]
    dtype = poses.dtype
    device = poses.translation.device
    steps = torch.arange(t - 1, dtype=torch.int32, device=device)
    ij = torch.stack([steps, steps + 1], dim=-1)
    meas = odometry_measurements
    weights = torch.as_tensor(odometry_weight, dtype=dtype, device=device).expand(t - 1)
    sqrt_info = None
    if loop_edges is not None and loop_edges.shape[0] > 0:
        k = loop_edges.shape[0]
        ij = torch.cat([ij, torch.as_tensor(loop_edges, device=device).to(torch.int32)])
        meas = RigidTransform(torch.cat([meas.rotation, loop_measurements.rotation]),
                              torch.cat([meas.translation, loop_measurements.translation]))
        weights = torch.cat(
            [weights, torch.as_tensor(loop_weight, dtype=dtype, device=device).expand(k)])
        if loop_information is not None:
            from .ops.covariance import sqrt_information

            d = lie.dof(poses.dim)
            eye = torch.eye(d, dtype=dtype, device=device).expand(t - 1, d, d)
            sqrt_info = torch.cat([eye, sqrt_information(loop_information).to(dtype)])
    return PoseGraph(poses=poses, edges_ij=ij, measurements=meas,
                     weights=weights.contiguous(), sqrt_information=sqrt_info)
